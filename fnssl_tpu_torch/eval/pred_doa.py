"""End-to-end prediction → DOA → metrics wrappers (port of ``PredDOA``,
``PredDOAMultiTrack``, ``ipd_baseline`` and ``predgt2doa_cls`` from
``fnssl_tpu/eval/pred_doa.py``)."""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from fnssl_tpu_torch.core.pairs import pair_unbatch
from fnssl_tpu_torch.eval.decode import (
    idl_decode, pd_decode, template_ri, time_pool_ipd)
from fnssl_tpu_torch.eval.metrics import (
    get_metric_multiple, get_metric_single)
from fnssl_tpu_torch.physics.dpipd import DPIPD
from fnssl_tpu_torch.utils.device import resolve_device


class PredDOA:
    """DOA decoding + metrics for the 2-mic FN-SSL model.

    The decode grid is the reference's: the full (res_the × res_phi)
    far-field template cropped to the single ele=π/2 row and the half
    azimuth plane, re-labelled 0..π over 37 points. ``method_mode`` is
    'IDL' (iterative detection & localization) or 'PD' (peak detection).
    ``device=None`` is the first CUDA device.
    """

    def __init__(self, method_mode: str = "IDL",
                 source_num_mode: str = "kNum", max_num_sources: int = 1,
                 res_the: int = 37, res_phi: int = 73, fs: int = 16000,
                 nfft: int = 512, ch_mode: str = "MM",
                 mic_location=((-0.04, 0.0, 0.0), (0.04, 0.0, 0.0)),
                 speed: float = 340.0, device=None):
        if method_mode not in ("IDL", "PD"):
            raise ValueError(f"unknown method_mode {method_mode!r}")
        device = resolve_device(device)
        self.method_mode = method_mode
        self.source_num_mode = source_num_mode
        self.max_num_sources = max_num_sources
        self.fre_used = slice(1, nfft // 2 + 1)
        dpipd = DPIPD(ndoa_candidate=[res_the, res_phi],
                      mic_location=np.asarray(mic_location),
                      nf=nfft // 2 + 1, fre_max=fs / 2, ch_mode=ch_mode,
                      speed=speed)
        tmpl = template_ri(dpipd.template, self.fre_used)
        nele, nazi = tmpl.shape[:2]
        # crop: middle elevation row, half azimuth plane (redefined 0..π)
        self.template = torch.as_tensor(
            tmpl[(nele - 1) // 2: (nele - 1) // 2 + 1, (nazi - 1) // 2:],
            device=device)
        self.ele_candidate = torch.tensor([np.pi / 2], dtype=torch.float32,
                                          device=device)
        self.azi_candidate = torch.as_tensor(np.linspace(0.0, np.pi, 37),
                                             dtype=torch.float32,
                                             device=device)

    def predgt2doa(self, pred_ipd, gt_batch=None, time_pool_size=None):
        """(nb·P, nt, 2nf) model output → pred dict {'doa', 'vad_sources',
        'spatial_spectrum'} (radians), on the decoder's device."""
        p = self.template.shape[-1]
        pred_ipd = torch.as_tensor(pred_ipd).to(self.template.device)
        nb = pred_ipd.shape[0] // p
        ipd = pair_unbatch(pred_ipd, nb).permute(0, 2, 3, 1)  # (nb,nt,2nf,P)
        if time_pool_size:
            ipd = time_pool_ipd(ipd, time_pool_size)
        decode = idl_decode if self.method_mode == "IDL" else pd_decode
        res = decode(ipd, self.template, self.ele_candidate,
                     self.azi_candidate,
                     max_num_sources=self.max_num_sources,
                     source_num_mode=self.source_num_mode)
        pred = {"doa": res.doa, "vad_sources": res.vad,
                "spatial_spectrum": res.spatial_spectrum}
        return pred, gt_batch

    def evaluate(self, pred, gt, ae_mode: Sequence[str] = ("azi",),
                 ae_th: float = 5.0, use_vad: bool = True,
                 vad_th=(2 / 3, 2 / 3), source_mode: str = "single"):
        """Metrics in degrees (Lightning/Module.py:748-773 defaults), on
        the host."""
        doa_gt = np.degrees(_host(gt["doa"]).astype(np.float64))
        doa_est = np.degrees(_host(pred["doa"]).astype(np.float64))
        fn = (get_metric_single if source_mode == "single"
              else get_metric_multiple)
        return fn(doa_gt, _host(gt["vad_sources"]), doa_est,
                  _host(pred["vad_sources"]), ae_mode=ae_mode,
                  ae_th=ae_th, use_vad=use_vad, vad_th=vad_th)

    def __call__(self, pred_batch, gt_batch, **metric_kw):
        pred, gt = self.predgt2doa(pred_batch, gt_batch)
        return self.evaluate(pred, gt, **metric_kw)


class PredDOAMultiTrack:
    """Multi-track IPDnet decode + metrics (IPDnet/Module.py:423-600).

    Each track's (nb, nt, 2nf, P) IPD is decoded on its own by
    single-source IDL on an azimuth-only grid (ele = π/2, azi 0..π over
    ``res_phi`` points), its VAD the least-squares template scale
    ('unkNum'); the tracks are stacked and scored with Hungarian-matched
    multi-source metrics (``ae_th`` 10, ``vad_th`` (0.001, 0.5)).
    ``save_dir`` writes the per-batch npy dumps (Module.py:592-597).

    ``scale_norm="utterance"`` divides each utterance's VAD scores by
    max(its own 95th percentile, ``scale_norm_floor``), which makes the
    0.5 gate scale-invariant across arrays the model never saw (the JAX
    package's docstring gives the measurement); off by default, the
    reference's decode. ``device=None`` is the first CUDA device.
    """

    def __init__(self, mic_location, max_track: int = 2,
                 res_the: int = 1, res_phi: int = 180, fs: int = 16000,
                 nfft: int = 512, ch_mode: str = "M",
                 speed: float = 340.0, save_dir: str | None = None,
                 scale_norm: str | None = None,
                 scale_norm_floor: float = 0.5, device=None):
        if scale_norm not in (None, "utterance"):
            raise ValueError(f"unknown scale_norm {scale_norm!r}")
        device = resolve_device(device)
        self.scale_norm = scale_norm
        self.scale_norm_floor = scale_norm_floor
        self.max_track = max_track
        self.fre_used = slice(1, nfft // 2 + 1)
        self.save_dir = save_dir
        dpipd = DPIPD(ndoa_candidate=[res_the, res_phi],
                      mic_location=np.asarray(mic_location),
                      nf=nfft // 2 + 1, fre_max=fs / 2, ch_mode=ch_mode,
                      speed=speed, ele_range=(np.pi / 2, np.pi / 2),
                      azi_range=(0.0, np.pi))
        self.template = torch.as_tensor(
            template_ri(dpipd.template, self.fre_used), device=device)
        self.ele_candidate = torch.full((res_the,), np.pi / 2,
                                        dtype=torch.float32, device=device)
        self.azi_candidate = torch.as_tensor(
            np.linspace(0.0, np.pi, res_phi).astype(np.float32),
            device=device)

    def pred2doa(self, pred, gt_batch=None):
        """pred: (nb, nt, 2nf, P, max_track) model output → {'doa' (nb, nt,
        2, tracks) radians, 'vad_sources' (nb, nt, tracks)} on the
        decoder's device."""
        pred = torch.as_tensor(pred).to(self.template.device).float()
        doas, vads = [], []
        for track in range(self.max_track):
            res = idl_decode(pred[..., track], self.template,
                             self.ele_candidate, self.azi_candidate,
                             max_num_sources=1, source_num_mode="unkNum")
            doas.append(res.doa[..., 0])
            vads.append(res.vad[..., 0])
        vad = torch.stack(vads, dim=-1)              # (nb, nt, tracks)
        if self.scale_norm == "utterance":
            q = torch.quantile(vad.reshape(vad.shape[0], -1), 0.95, dim=1)
            vad = vad / q.clamp_min(self.scale_norm_floor)[:, None, None]
        return {"doa": torch.stack(doas, dim=-1), "vad_sources": vad}, \
            gt_batch

    def evaluate(self, pred, gt, ae_th: float = 10.0,
                 vad_th=(0.001, 0.5), idx: int | None = None):
        """Metrics in degrees, on the host; with ``save_dir`` and ``idx``,
        the batch's gt/est DOA and VAD as ``<idx>_<name>.npy``."""
        doa_gt = np.degrees(_host(gt["doa"]).astype(np.float64))
        doa_est = np.degrees(_host(pred["doa"]).astype(np.float64))
        vad_gt = _host(gt["vad_sources"])
        vad_est = _host(pred["vad_sources"])
        if self.save_dir is not None and idx is not None:
            os.makedirs(self.save_dir, exist_ok=True)
            for name, arr in (("doagt", doa_gt), ("doaest", doa_est),
                              ("vadgt", vad_gt), ("vadest", vad_est)):
                np.save(os.path.join(self.save_dir, f"{idx}_{name}.npy"),
                        arr)
        return get_metric_multiple(doa_gt, vad_gt, doa_est, vad_est,
                                   ae_mode=("azi",), ae_th=ae_th,
                                   use_vad=True, vad_th=vad_th)

    def __call__(self, pred_batch, gt_batch, idx: int | None = None, **kw):
        pred, gt = self.pred2doa(pred_batch, gt_batch)
        return self.evaluate(pred, gt, idx=idx, **kw)


def ipd_baseline(mic_sig, decoder: PredDOA, *, nfft: int = 512,
                 win_len: int = 512, win_shift_ratio: float = 0.5,
                 time_pool_size: int = 12):
    """DNN-free localization baseline: decode the measured cross-spectrum
    IPD directly on the template grid, on the decoder's device.

    The reference's ``wDNN=False`` path (Learner.py:208-214) subtracts the
    normalized imaginary parts of the two channels as a stand-in for
    phase; this decodes the inter-channel phase difference
    exp(j·(∠X₁−∠X₂)), which the DP-IPD templates model, as the JAX package
    does.

    Args: mic_sig (nb, nsample, 2). Returns the PredDOA pred dict.
    """
    from fnssl_tpu_torch.core.stft import stft

    sig = torch.as_tensor(mic_sig, dtype=torch.float32,
                          device=decoder.template.device)
    spec = stft(sig, win_len=win_len, win_shift_ratio=win_shift_ratio,
                nfft=nfft)                          # (nb, nf, nt, 2)
    cross = spec[..., 0] * torch.conj(spec[..., 1])  # (nb, nf, nt)
    ipd = cross / (cross.abs() + 1e-8)
    sel = ipd[:, 1: nfft // 2 + 1]
    pred = torch.cat([sel.real, sel.imag], dim=1).permute(0, 2, 1)
    return decoder.predgt2doa(pred, time_pool_size=time_pool_size)[0]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def predgt2doa_cls(pred_logits, gt_batch=None):
    """Classification-head decode (Learner.py:489-505): argmax class =
    azimuth in degrees; unit VAD. Returns DOA in *radians* like the
    regression path so ``PredDOA.evaluate`` treats both identically."""
    cls = torch.argmax(torch.as_tensor(pred_logits), dim=-1)   # (nb, nt)
    azi = torch.deg2rad(cls.to(torch.float32))
    ele = torch.full_like(azi, np.pi / 2)
    doa = torch.stack([ele, azi], dim=2)[..., None]           # (nb,nt,2,1)
    vad = torch.ones(cls.shape + (1,), dtype=torch.float32,
                     device=cls.device)
    return {"doa": doa, "vad_sources": vad}, gt_batch
