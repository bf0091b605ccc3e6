"""Training tasks: preprocessing + model + loss as one function (port of
``fnssl_tpu/train/tasks.py``).

Each ``make_*_task`` builds ``loss_fn(module, batch, generator) ->
scalar`` for ``train.step.make_train_step``: the reference's
data_preprocess → forward → cal_loss chain (Lightning/main.py:149-157),
run on the task's device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from fnssl_tpu_torch.core.stft import num_frames
from fnssl_tpu_torch.models.fnssl import FNSSLConfig
from fnssl_tpu_torch.models.ipdnet import IPDnetConfig, VariableIPDnetConfig
from fnssl_tpu_torch.data.arrays import audiowu_high_array_geometry
from fnssl_tpu_torch.models.spatialnet import SpatialNetConfig
from fnssl_tpu_torch.parallel.mesh import Mesh2D
from fnssl_tpu_torch.physics.dpipd import DPIPD, DPIPD2
from fnssl_tpu_torch.physics.targets import (bessel_nonsource_target,
                                             vad_gate_with_nonsource)
from fnssl_tpu_torch.train.losses import (ce_doa_loss, mse_ipd_loss,
                                          pit_mse_loss)
from fnssl_tpu_torch.train.precision import wrap_apply
from fnssl_tpu_torch.train.preprocess import (make_fnssl_preprocess,
                                              make_ipdnet_preprocess,
                                              stft_features)
from fnssl_tpu_torch.utils.device import resolve_device

# 2-mic linear array at ±4 cm — the FN-SSL training array
# (Lightning/main.py:121-123).
DUALCH_MIC_LOCATION = np.array([[-0.04, 0.0, 0.0], [0.04, 0.0, 0.0]])


class FNSSLTask(NamedTuple):
    loss_fn: object
    preprocess: object
    cfg: FNSSLConfig
    dpipd: DPIPD


def _apply_module(params, x, *, module, generator=None, **kw):
    """The module's forward with ``params`` in place of its own."""
    return functional_call(module, params, (x,),
                           {"generator": generator, **kw})


def _remat(apply_base):
    """``apply_base`` under ``torch.utils.checkpoint`` (activations
    recomputed in the backward). The dropout generator is rewound for the
    recomputation, so it draws the forward's masks again."""
    def fn(params, x, *, generator=None, **kw):
        state = None if generator is None else generator.get_state()

        def run(p, x_):
            if state is not None:
                generator.set_state(state)
            return apply_base(p, x_, generator=generator, **kw)

        return checkpoint(run, params, x, use_reentrant=False)
    return fn


def make_fnssl_task(cfg: FNSSLConfig = FNSSLConfig(),
                    mic_location: np.ndarray = DUALCH_MIC_LOCATION,
                    ch_mode: str = "MM", nfft: int = 512,
                    fs: int = 16000, speed: float = 340.0,
                    res_the: int = 37, res_phi: int = 73,
                    remat: bool = False, precision: str = "fp32",
                    device=None) -> FNSSLTask:
    """FN-SSL DP-IPD regression task (the flagship model), or azimuth
    classification with ``cfg.is_doa``.

    Batch contract: dict (numpy arrays or tensors) with
      'mic_sig' (nb, nsample, nch) float32,
      'doa' (nb, nt2, 2, ns) radians,
      'vad' (nb, nt2, ns) soft VAD at the output frame rate;
    moved to ``device`` (the first CUDA device unless given).

    ``loss_fn(module, batch, generator)`` runs dropout when ``generator``
    (a ``torch.Generator`` on the device) is given and not when it is
    None, like the JAX package's ``rng``. ``remat`` recomputes the
    model's activations in the backward (``torch.utils.checkpoint``);
    ``precision='bf16'`` is the mixed-precision policy of
    ``train.precision``, outermost so that recomputed activations are
    bf16 too.
    """
    device = resolve_device(device)
    dpipd = DPIPD(ndoa_candidate=[res_the, res_phi],
                  mic_location=mic_location, nf=nfft // 2 + 1,
                  fre_max=fs / 2, ch_mode=ch_mode, speed=speed)
    dpipd.tables(device)
    preprocess = make_fnssl_preprocess(dpipd, ch_mode=ch_mode, nfft=nfft)
    apply_fn = wrap_apply(_remat(_apply_module) if remat else _apply_module,
                          precision)

    def loss_fn(module, batch, generator=None):
        b = {k: torch.as_tensor(batch[k], device=device)
             for k in ("mic_sig", "doa", "vad")}
        feats, gt = preprocess(b["mic_sig"], b["doa"], b["vad"])
        pred = apply_fn(dict(module.named_parameters()), feats,
                        module=module, generator=generator)
        if cfg.is_doa:
            # CE on integer-degree azimuth classes (Learner.py:454-469;
            # truncation toward zero, as the reference's LongTensor cast)
            azi_deg = b["doa"][:, :, 1, 0] * (180.0 / np.pi)
            labels = azi_deg.to(torch.int32).clamp(0, 179)
            return ce_doa_loss(pred, labels)
        return mse_ipd_loss(pred, gt["ipd"], nb=b["mic_sig"].shape[0])

    return FNSSLTask(loss_fn, preprocess, cfg, dpipd)


class IPDnetTask(NamedTuple):
    loss_fn: object
    preprocess: object
    cfg: object
    dpipd: DPIPD


def _batch_on(batch, device):
    return {k: torch.as_tensor(batch[k], device=device)
            for k in ("mic_sig", "doa", "vad")}


def _ipdnet_task(cfg, mic_location, ch_mode, nfft, fs, speed,
                 vad_threshold, remat, precision, device, norm="online",
                 npair=None) -> IPDnetTask:
    """The three IPDnet tasks: DP-IPD targets on the (37, 73) grid with
    the Bessel non-source fill, the model and the frame-level PIT MSE.
    The variable-array task (``npair`` given) runs the net on pair
    features and crops pred and targets to the shorter frame count."""
    device = resolve_device(device)
    dpipd = DPIPD(ndoa_candidate=[37, 73], mic_location=mic_location,
                  nf=nfft // 2 + 1, fre_max=fs / 2, ch_mode=ch_mode,
                  speed=speed)
    dpipd.tables(device)
    nonsource = bessel_nonsource_target(
        mic_location, fre_used=slice(1, nfft // 2 + 1), nf=nfft // 2 + 1,
        fre_max=fs / 2, speed=speed, ch_mode=ch_mode)
    preprocess = make_ipdnet_preprocess(
        dpipd, nonsource, ch_mode="none" if npair is None else ch_mode,
        nfft=nfft, vad_threshold=vad_threshold, norm=norm)
    apply_fn = wrap_apply(_remat(_apply_module) if remat else _apply_module,
                          precision)
    extra = {} if npair is None else {"npair": npair}

    def loss_fn(module, batch, generator=None):
        b = _batch_on(batch, device)
        feats, gt = preprocess(b["mic_sig"], b["doa"], b["vad"])
        pred = apply_fn(dict(module.named_parameters()), feats,
                        module=module, generator=generator, **extra)
        target = gt["ipd"]
        if npair is not None:
            nt = min(pred.shape[1], target.shape[1])
            pred, target = pred[:, :nt], target[:, :nt]
        return pit_mse_loss(pred, target)

    return IPDnetTask(loss_fn, preprocess, cfg, dpipd)


def make_ipdnet_task(cfg=None, mic_location: np.ndarray | None = None,
                     nfft: int = 512, fs: int = 16000,
                     speed: float = 340.0, max_track: int = 2,
                     vad_threshold: float = 0.001, remat: bool = False,
                     precision: str = "fp32", device=None) -> IPDnetTask:
    """IPDnet multi-track DP-IPD task with frame-level PIT loss
    (runIPDnetOn.py:80-301).

    Batch contract: dict (numpy arrays or tensors) with
      'mic_sig' (nb, nsample, nch),
      'doa' (nb, nt2, 2, ns) radians,
      'vad' (nb, nt2, ns) soft dp-VAD at the output frame rate;
    moved to ``device`` (the first CUDA device unless given). ``remat``,
    ``precision`` and ``loss_fn``'s generator as in ``make_fnssl_task``.
    """
    if mic_location is None:
        mic_location = DUALCH_MIC_LOCATION
    if cfg is None:
        cfg = IPDnetConfig(input_size=2 * mic_location.shape[0],
                           max_track=max_track)
    return _ipdnet_task(cfg, mic_location, "M", nfft, fs, speed,
                        vad_threshold, remat, precision, device)


def make_variable_ipdnet_task(cfg=None,
                              mic_location: np.ndarray | None = None,
                              nfft: int = 512, fs: int = 16000,
                              speed: float = 340.0,
                              vad_threshold: float = 0.001,
                              remat: bool = False, precision: str = "fp32",
                              device=None) -> IPDnetTask:
    """Variable-array IPDnet task: mic pairs ride the batch axis in
    nb-major pair groups (VariableArrayIPDnet.py:107-118), PIT loss over
    the 2 tracks against all-pair ('MM') DP-IPD targets, pred and targets
    cropped to the shorter frame count (run_IPDnet2.py:183-189).

    Batch contract as ``make_ipdnet_task``; nb utterances of one array
    batch together (their pair means stay per utterance).
    """
    if mic_location is None:
        mic_location = DUALCH_MIC_LOCATION
    if cfg is None:
        cfg = VariableIPDnetConfig()
    n = mic_location.shape[0]
    return _ipdnet_task(cfg, mic_location, "MM", nfft, fs, speed,
                        vad_threshold, remat, precision, device,
                        npair=n * (n - 1) // 2)


def make_ipdnet_offline_task(cfg=None,
                             mic_location: np.ndarray | None = None,
                             nfft: int = 512, fs: int = 16000,
                             speed: float = 340.0, max_track: int = 2,
                             vad_threshold: float = 0.001,
                             remat: bool = False, precision: str = "fp32",
                             device=None) -> IPDnetTask:
    """Offline IPDnet (runIPDnetOff.py:79-303): bidirectional narrow-band
    LSTMs and the global magnitude normalisation instead of the
    forgetting norm. The loss runs the net on the whole input; the test
    step scores the 312-frame chunked inference (``IPDnet(...,
    offline_inference=True)``)."""
    if mic_location is None:
        mic_location = DUALCH_MIC_LOCATION
    if cfg is None:
        cfg = IPDnetConfig(input_size=2 * mic_location.shape[0],
                           max_track=max_track, is_online=False)
    return _ipdnet_task(cfg, mic_location, "M", nfft, fs, speed,
                        vad_threshold, remat, precision, device,
                        norm="offline")


# the 5-mic subset of the Westlake 32-mic array IPDnet2 trains on (RealMAN)
IPDNET2_MIC_IDS = (0, 1, 3, 5, 7)
IPDNET2_KEYS = ("mic_sig", "azi_deg", "distance", "vad", "mic_pos")


def make_ipdnet2_task(cfg=None, mic_location: np.ndarray | None = None,
                      nfft: int = 512, fs: int = 16000,
                      speed: float = 340.0, remat: bool = False,
                      precision: str = "fp32", feats_sharding=None,
                      device=None) -> IPDnetTask:
    """IPDnet2/OnlineSpatialNet near-field task (run_IPDnet2.py:82-339):
    STFT center=True hop 0.625, forgetting-norm L=249, all channels;
    near-field DP-IPD targets (``DPIPD2``) from the batch's own array
    topology; the Bessel non-source fill where a track's VAD is 0; the
    frame-level PIT MSE after the reconcile of pred and target frame
    counts (run_IPDnet2.py:183-189).

    Batch contract: dict (numpy arrays or tensors) with
      'mic_sig' (nb, nsample, nch),
      'azi_deg' (nb, nt2, ns) azimuth targets in degrees (10 Hz stream),
      'distance' (nb, nt2, ns) meters,
      'vad' (nb, nt2, ns),
      'mic_pos' (nb, nmic, 3) per-batch topology;
    moved to ``device`` (the first CUDA device unless given). ``remat``,
    ``precision`` and ``loss_fn``'s generator as in ``make_fnssl_task``
    (the model has no dropout).

    ``feats_sharding``, a 2-D mesh (``parallel.make_mesh_2d``), is the
    JAX package's ``NamedSharding(mesh, P('data', None, 'freq', None))``:
    ``loss_fn`` then takes the rank's rows of the global batch
    (``shard_batch(batch, mesh=mesh)``), runs the preprocess whole along
    frequency (the forgetting norm averages over all bins), gives the
    model this rank's bins and computes the loss on the gathered output.
    Train it with ``make_train_step(loss_fn, tx, mesh=mesh)``, which
    averages the gradients over the mesh's world.
    """
    if feats_sharding is not None and not isinstance(feats_sharding, Mesh2D):
        raise TypeError("feats_sharding takes a 2-D mesh "
                        "(parallel.make_mesh_2d)")
    mesh = feats_sharding
    device = resolve_device(device)
    if mic_location is None:
        mic_location = audiowu_high_array_geometry()[list(IPDNET2_MIC_IDS)]
    nmic = mic_location.shape[0]
    if cfg is None:
        cfg = SpatialNetConfig(dim_input=2 * nmic, dim_output=4 * (nmic - 1))
    dpipd2 = DPIPD2(ndoa_candidate=[1, 180], mic_location=mic_location,
                    nf=nfft // 2 + 1, fre_max=fs / 2, ch_mode="M",
                    speed=speed)
    nonsource = torch.as_tensor(bessel_nonsource_target(
        mic_location, fre_used=slice(1, nfft // 2 + 1), nf=nfft // 2 + 1,
        fre_max=fs / 2, speed=speed), dtype=torch.float32, device=device)
    fre_used = slice(1, nfft // 2 + 1)

    def preprocess(mic_sig, azi_deg, distance, vad, mic_pos):
        feats = stft_features(mic_sig, ch_mode="none", win_len=nfft,
                              win_shift_ratio=0.625, nfft=nfft,
                              center=True, sample_length=249)
        ele = torch.full_like(azi_deg, 90.0)
        doa = torch.stack([ele, azi_deg], dim=2) * (np.pi / 180.0)
        ipd = dpipd2.targets(doa, distance, mic_pos)
        ipd = torch.cat([ipd.real[:, :, fre_used], ipd.imag[:, :, fre_used]],
                        dim=2).float()
        return feats, {"ipd": vad_gate_with_nonsource(ipd, vad, nonsource,
                                                      threshold=0.0)}

    apply_fn = wrap_apply(_remat(_apply_module) if remat else _apply_module,
                          precision)

    def loss_fn(module, batch, generator=None):
        b = {k: torch.as_tensor(batch[k], device=device)
             for k in IPDNET2_KEYS}
        feats, gt = preprocess(*(b[k] for k in IPDNET2_KEYS))
        kw = {}
        if mesh is not None:         # the rows are the rank's already
            n = feats.shape[2] // mesh.n_freq
            feats = feats[:, :, mesh.freq_index * n:
                          (mesh.freq_index + 1) * n]
            kw["freq_mesh"] = mesh
        pred = apply_fn(dict(module.named_parameters()), feats,
                        module=module, generator=generator, **kw)
        nt = min(pred.shape[1], gt["ipd"].shape[1])
        return pit_mse_loss(pred[:, :nt], gt["ipd"][:, :nt])

    return IPDnetTask(loss_fn, preprocess, cfg, dpipd2)


def synthetic_fnssl_batch(nb: int = 2, t_s: float = 4.79, fs: int = 16000,
                          nch: int = 2, ns: int = 1, seed: int = 0,
                          win_len: int = 512, win_shift_ratio: float = 0.5,
                          pool: int = 12):
    """Random batch matching the FN-SSL data contract (numpy), drawn as
    the JAX package draws it, so that both see the same batch."""
    rng = np.random.default_rng(seed)
    nsample = int(t_s * fs)
    nt = num_frames(nsample, win_len, win_shift_ratio, center=False)
    nt2 = nt // pool
    return {
        "mic_sig": rng.standard_normal((nb, nsample, nch)).astype(np.float32),
        "doa": np.stack([
            np.full((nb, nt2, ns), np.pi / 2, np.float32),
            rng.uniform(-np.pi, np.pi, (nb, nt2, ns)).astype(np.float32),
        ], axis=2),
        "vad": np.ones((nb, nt2, ns), np.float32),
    }
