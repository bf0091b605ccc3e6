"""Online magnitude normalization (port of ``fnssl_tpu/core/norm.py``).

``forgetting_norm`` is the reference's exponential running mean of the
per-frame magnitude, start-up quirk included: the smoothing factor at
frame i is

    alp_i = min((i-1)/(i+1), alpha),  alpha = (L-1)/(L+1)

so alp is -1 at frame 0 and 0 at frame 1. Every running product of alp
from frame 1 on is therefore 0, which rules out a closed form that
divides cumulative products. The recurrence mu_i = a_i·mu_{i-1} + b_i is
an affine map, and maps compose associatively, so a log-depth
Hillis–Steele doubling over the frames replaces the sequential loop.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ForgettingNormState(NamedTuple):
    """Streaming carry: running mean and absolute frame index."""
    mu: torch.Tensor   # (nb,) float32 running magnitude mean
    frame0: int        # index of the next frame


def init_state(nb: int, device=None) -> ForgettingNormState:
    return ForgettingNormState(mu=torch.zeros(nb, device=device), frame0=0)


def forgetting_norm(mag: torch.Tensor, sample_length: int = 298
                    ) -> torch.Tensor:
    """Running mean of |STFT| over frames.

    Args:
      mag: (nb, nch, nf, nt) magnitude.
    Returns:
      (nb, 1, 1, nt) divisor (the caller divides real/imag by it + eps).
    """
    out, _ = forgetting_norm_streaming(
        mag, init_state(mag.shape[0], mag.device),
        sample_length=sample_length)
    return out


def _affine_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan over axis 0 of the maps mu ↦ a·mu + b, the later
    map applied after the earlier: (a1, b1) then (a2, b2) is
    (a1·a2, a2·b1 + b2)."""
    shift = 1
    while shift < a.shape[0]:
        a_prev, b_prev = a[:-shift], b[:-shift]
        a_cur, b_cur = a[shift:], b[shift:]
        a = torch.cat([a[:shift], a_prev * a_cur])
        b = torch.cat([b[:shift], a_cur * b_prev + b_cur])
        shift *= 2
    return a, b


def forgetting_norm_streaming(
    mag: torch.Tensor, state: ForgettingNormState, *,
    sample_length: int = 298
) -> tuple[torch.Tensor, ForgettingNormState]:
    """Chunked variant carrying running statistics across calls."""
    nb, nch, nf, nt = mag.shape
    frame_mean = mag.reshape(nb, nch * nf, nt).mean(dim=1)   # (nb, nt)

    alpha = (sample_length - 1) / (sample_length + 1)
    i = state.frame0 + torch.arange(nt, dtype=torch.float32,
                                    device=mag.device)
    alp = torch.clamp_max((i - 1.0) / (i + 1.0), alpha)      # (nt,)

    a = alp[:, None].expand(nt, nb)
    b = (1.0 - alp)[:, None] * frame_mean.T
    acc_a, acc_b = _affine_scan(a, b)
    mus = acc_a * state.mu[None, :] + acc_b                  # (nt, nb)
    out = mus.T.reshape(nb, 1, 1, nt)
    return out, ForgettingNormState(mu=mus[-1], frame0=state.frame0 + nt)


def offline_norm(mag: torch.Tensor) -> torch.Tensor:
    """Global magnitude mean, the offline-IPDnet normalizer.
    mag: (nb, nch, nf, nt)."""
    nb = mag.shape[0]
    return mag.reshape(nb, -1).mean(dim=1).reshape(nb, 1, 1, 1)
