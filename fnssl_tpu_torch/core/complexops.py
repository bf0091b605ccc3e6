"""Complex helpers on (..., 2) real/imag stacks (port of
``fnssl_tpu/core/complexops.py``; parity: FN-SSL/Module.py:12-23)."""
from __future__ import annotations

import torch


def complex_multiplication(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x0 + i x1)(y0 + i y1) on (..., 2) stacks."""
    return torch.stack(
        [x[..., 0] * y[..., 0] - x[..., 1] * y[..., 1],
         x[..., 0] * y[..., 1] + x[..., 1] * y[..., 0]], dim=-1)


def complex_conjugate_multiplication(x: torch.Tensor,
                                     y: torch.Tensor) -> torch.Tensor:
    """x * conj(y) on (..., 2) stacks: the reference's "conjugate
    multiplication" conjugates the second operand (FN-SSL/Module.py:16-17),
    as the JAX package keeps it."""
    return torch.stack(
        [x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1],
         x[..., 1] * y[..., 0] - x[..., 0] * y[..., 1]], dim=-1)


def complex_cart2polar(x: torch.Tensor) -> torch.Tensor:
    """(re, im) → (magnitude, phase) on (..., 2) stacks."""
    mod = torch.sqrt(complex_conjugate_multiplication(x, x)[..., 0])
    phase = torch.atan2(x[..., 1], x[..., 0])
    return torch.stack((mod, phase), dim=-1)
