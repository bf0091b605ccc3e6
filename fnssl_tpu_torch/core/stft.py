"""Batched multichannel STFT and its inverse (port of
``fnssl_tpu/core/stft.py``).

  * FN-SSL / IPDnet convention: ``center=False``,
    ``nt = floor((nsample - win_len)/hop) + 1``.
  * IPDnet2 convention: ``center=True`` (reflect pad nfft//2 each side),
    ``nt = floor(nsample/hop) + 1``.

The whole (batch, channel, frame) volume goes through one
``torch.fft.rfft``. Input (nb, nsample, nch), output (nb, nf, nt, nch)
complex64, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_len: int, dtype=torch.float32, device=None
                ) -> torch.Tensor:
    """Periodic Hann window (same as torch.hann_window(periodic=True)),
    computed in float64 and cast, as the JAX package does."""
    n = np.arange(win_len)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_len)
    return torch.as_tensor(w, dtype=dtype, device=device)


def _get_window(win: str, win_len: int, device) -> torch.Tensor:
    if win == "hann":
        return hann_window(win_len, device=device)
    if win == "boxcar":
        return torch.ones(win_len, device=device)
    raise ValueError(f"unknown window {win!r}")


def num_frames(nsample: int, win_len: int, win_shift_ratio: float,
               center: bool = False) -> int:
    """Frame count for the given STFT convention."""
    hop = int(win_len * win_shift_ratio)
    if center:
        return int(np.floor(nsample / hop)) + 1
    return int(np.floor((nsample - win_len) / hop + 1))


def stft(signal: torch.Tensor, *, win_len: int = 512,
         win_shift_ratio: float = 0.5, nfft: int = 512, win: str = "hann",
         center: bool = False) -> torch.Tensor:
    """STFT of multichannel signals.

    Args:
      signal: (nb, nsample, nch) float.
      center: False → FN-SSL convention; True → IPDnet2 convention.

    Returns:
      (nb, nf, nt, nch) complex64 with nf = nfft//2 + 1.
    """
    hop = int(win_len * win_shift_ratio)
    nt = num_frames(signal.shape[1], win_len, win_shift_ratio, center)
    x = signal.float().permute(0, 2, 1)               # (nb, nch, ns)
    if center:
        pad = nfft // 2
        x = F.pad(x, (pad, pad), mode="reflect")
    frames = x.unfold(-1, win_len, hop)[:, :, :nt]    # (nb, nch, nt, win)
    frames = frames * _get_window(win, win_len, signal.device)
    if nfft > win_len:  # torch zero-pads the window centre-aligned
        lpad = (nfft - win_len) // 2
        frames = F.pad(frames, (lpad, nfft - win_len - lpad))
    spec = torch.fft.rfft(frames, n=nfft, dim=-1).to(torch.complex64)
    return spec.permute(0, 3, 2, 1)                   # (nb, nf, nt, nch)


def istft(spec: torch.Tensor, *, win_len: int = 512,
          win_shift_ratio: float = 0.5, nfft: int = 512) -> torch.Tensor:
    """Inverse STFT with overlap-add, matching torch.istft(center=True).

    Args:
      spec: (nb, nf, nt, nch) complex.

    Returns:
      (nb, nsample, nch) float32 with nsample = (nt-1)*hop, the reference
      ISTFT's crop (FN-SSL/Module.py:70-99).
    """
    nb, nf, nt, nch = spec.shape
    hop = int(win_len * win_shift_ratio)
    nsample = (nt - 1) * hop
    x = spec.permute(0, 3, 2, 1)                      # (nb, nch, nt, nf)
    window = hann_window(win_len, device=spec.device)
    frames = torch.fft.irfft(x, n=nfft, dim=-1)[..., :win_len] * window
    # overlap-add of every frame at its hop offset
    idx = torch.as_tensor(
        (np.arange(nt)[:, None] * hop + np.arange(win_len)[None, :]).ravel(),
        device=spec.device)
    total = (nt - 1) * hop + win_len
    sig = torch.zeros(nb, nch, total, device=spec.device).index_add_(
        -1, idx, frames.reshape(nb, nch, -1).float())
    # window-envelope normalization (as torch.istft)
    env = torch.zeros(total, device=spec.device).index_add_(
        0, idx, (window ** 2).repeat(nt))
    sig = sig / env.clamp_min(1e-11)
    pad = nfft // 2                                   # center=True crop
    return sig[:, :, pad:pad + nsample].permute(0, 2, 1)
