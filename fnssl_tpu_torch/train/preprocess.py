"""STFT front-end features (port of ``stft_features`` in
``fnssl_tpu/train/preprocess.py``; the training preprocess closures are
not ported yet)."""
from __future__ import annotations

import torch

from fnssl_tpu_torch.core.norm import forgetting_norm, offline_norm
from fnssl_tpu_torch.core.pairs import pair_rebatch
from fnssl_tpu_torch.core.stft import stft


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
