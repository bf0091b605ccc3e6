"""Small layers with torch-compatible parameter naming (port of the
parts of ``fnssl_tpu/models/layers.py`` that FN-SSL uses)."""
from __future__ import annotations

import math

import torch
from torch import nn


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    return x @ weight.T + bias


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout (torch semantics). Identity when not training or
    when no generator is given, as the JAX package's is without an rng."""
    if not training or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def avg_pool_time(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, T, C) → (B, T//k, C), mean over non-overlapping windows of k;
    the last T % k steps are dropped."""
    b, t, c = x.shape
    t2 = t // k
    return x[:, : t2 * k].reshape(b, t2, k, c).mean(dim=2)


def uniform_(p: torch.Tensor, bound: float,
             generator: torch.Generator | None) -> None:
    """U(-bound, bound) in place, drawn on the CPU from ``generator`` so
    that a seed gives the same weights on every device."""
    with torch.no_grad():
        draw = torch.rand(p.shape, generator=generator, dtype=torch.float32)
        p.copy_(draw * (2 * bound) - bound)


class Linear(nn.Module):
    """nn.Linear's parameters (``weight`` (out, in), ``bias``) with the
    JAX package's init U(-1/sqrt(in), 1/sqrt(in)) for both."""

    def __init__(self, in_features: int, out_features: int, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))
        k = 1.0 / math.sqrt(in_features)
        uniform_(self.weight, k, generator)
        uniform_(self.bias, k, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)
