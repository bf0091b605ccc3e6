"""On-line training-step preprocessing: STFT front-end features and
DP-IPD targets (port of ``fnssl_tpu/train/preprocess.py``).

As in the JAX package, the STFT and the ground-truth DP-IPD are made
inside the training step from the batch's tensors, on their device."""
from __future__ import annotations

import numpy as np
import torch

from fnssl_tpu_torch.core.norm import forgetting_norm, offline_norm
from fnssl_tpu_torch.core.pairs import pair_rebatch
from fnssl_tpu_torch.core.stft import stft
from fnssl_tpu_torch.physics.targets import (ipd_complex_to_ri,
                                             vad_gate_with_nonsource,
                                             vad_mask_and_sum)


def stft_features(mic_sig: torch.Tensor, *, ch_mode: str = "MM",
                  win_len: int = 512, win_shift_ratio: float = 0.5,
                  nfft: int = 512, center: bool = False,
                  norm: str = "online", sample_length: int = 298,
                  eps: float = 1e-6) -> torch.Tensor:
    """Mic signals → normalized real/imag pair features.

    Args:
      mic_sig: (nb, nsample, nch) time signals.
      norm: 'online' (forgetting_norm, causal), 'offline' (global mean),
        or 'none'.

    Returns:
      (nb*P, 4, nfft//2, nt) float32: channels [re(m0), re(m1), im(m0),
      im(m1)] over bins 1..nfft/2, the model input layout.
    """
    spec = stft(mic_sig, win_len=win_len, win_shift_ratio=win_shift_ratio,
                nfft=nfft, center=center)            # (nb, nf, nt, nch)
    spec = spec.permute(0, 3, 1, 2)                  # (nb, nch, nf, nt)
    pairs = spec if ch_mode == "none" else pair_rebatch(spec, ch_mode)
    if norm == "online":
        denom = forgetting_norm(pairs.abs(), sample_length=sample_length) \
            + eps
    elif norm == "offline":
        denom = offline_norm(pairs.abs()) + eps
    else:
        denom = torch.ones((), device=pairs.device)
    feats = torch.cat([pairs.real / denom, pairs.imag / denom], dim=1)
    return feats[:, :, 1: nfft // 2 + 1, :]


def make_fnssl_preprocess(dpipd, *, ch_mode: str = "MM",
                          win_len: int = 512, win_shift_ratio: float = 0.5,
                          nfft: int = 512, sample_length: int = 298):
    """Build the FN-SSL (features, targets) preprocessing function.

    ``dpipd`` is a ``physics.dpipd.DPIPD``.

    Returns fn(mic_sig, doa, vad) → (features, {'ipd', 'doa',
    'vad_sources'}) on the inputs' device:
      mic_sig (nb, nsample, nch) float32; doa (nb, nt2, 2, ns) radians;
      vad (nb, nt2, ns) soft VAD at the segment rate;
      features (nb*P, 4, nfft/2, nt); ipd (nb, nt2, 2·nfft/2, P) float32.
    """
    fre_used = slice(1, nfft // 2 + 1)

    def preprocess(mic_sig, doa, vad):
        feats = stft_features(
            mic_sig, ch_mode=ch_mode, win_len=win_len,
            win_shift_ratio=win_shift_ratio, nfft=nfft,
            sample_length=sample_length)
        ipd = ipd_complex_to_ri(dpipd.targets(doa), fre_used)
        return feats, {"ipd": vad_mask_and_sum(ipd, vad), "doa": doa,
                       "vad_sources": vad}

    return preprocess


def make_ipdnet_preprocess(dpipd, nonsource, *, ch_mode: str = "none",
                           win_len: int = 512, win_shift_ratio: float = 0.5,
                           nfft: int = 512, sample_length: int = 280,
                           vad_threshold: float = 0.001,
                           norm: str = "online"):
    """IPDnet multi-track preprocessing: per-track targets with the
    Bessel non-source fill on silent frames (runIPDnetOn.py:236-301).

    ``nonsource`` is the (2nf, P) Bessel target
    (``physics.targets.bessel_nonsource_target``); ``norm='offline'`` is
    the offline model's global-mean normalisation
    (runIPDnetOff.py:249-251).

    Returns fn(mic_sig, doa, vad) → (features, {'ipd', 'doa',
    'vad_sources'}) on the inputs' device: features (nb, 2·nch, nfft/2,
    nt) with ``ch_mode='none'``; 'ipd' (nb, nt2, 2·nfft/2, P, ns)
    per-track targets for the PIT loss.
    """
    fre_used = slice(1, nfft // 2 + 1)
    host = torch.as_tensor(np.asarray(nonsource, np.float32))
    on_device = {}                # the target, copied once to each device

    def preprocess(mic_sig, doa, vad):
        feats = stft_features(
            mic_sig, ch_mode=ch_mode, win_len=win_len,
            win_shift_ratio=win_shift_ratio, nfft=nfft, norm=norm,
            sample_length=sample_length)
        ipd = ipd_complex_to_ri(dpipd.targets(doa), fre_used)
        if ipd.device not in on_device:
            on_device[ipd.device] = host.to(ipd.device)
        gt = vad_gate_with_nonsource(ipd, vad, on_device[ipd.device],
                                     threshold=vad_threshold)
        return feats, {"ipd": gt, "doa": doa, "vad_sources": vad}

    return preprocess
