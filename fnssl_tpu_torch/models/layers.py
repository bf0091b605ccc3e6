"""Small layers with torch-compatible parameter naming (port of
``fnssl_tpu/models/layers.py``: the parts that FN-SSL, IPDnet and
IPDnet2 use)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    return x @ weight.T + bias


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two (JAX's promotion: a
    float32 operand lifts a bfloat16 one)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout (torch semantics). Identity when not training or
    when no generator is given, as the JAX package's is without an rng."""
    if not training or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None,
           padding=((0, 0), (0, 0))) -> torch.Tensor:
    """NCHW conv with OIHW weights and explicit symmetric (h, w) padding
    (``lax.conv_general_dilated`` in the JAX package, cuDNN here)."""
    (ph0, ph1), (pw0, pw1) = padding
    if ph0 != ph1 or pw0 != pw1:
        x = F.pad(x, (pw0, pw1, ph0, ph1))
        return F.conv2d(x, weight, bias)
    return F.conv2d(x, weight, bias, padding=(ph0, pw0))


def prelu(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """torch nn.PReLU with one shared slope ``weight`` (shape (1,))."""
    return torch.where(x >= 0, x, weight * x)


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


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-5, weight ones, bias zeros."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones((dim,), device=device))
        self.bias = nn.Parameter(torch.zeros((dim,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.weight.to(x.dtype),
                            self.bias.to(x.dtype), 1e-5)


class Params(nn.Module):
    """A holder of named parameters, zeros of the given shapes (a torch
    submodule's state-dict names, e.g. ``out_proj.weight``)."""

    def __init__(self, device=None, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.zeros(shape,
                                                         device=device)))


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


class Conv2d(nn.Module):
    """nn.Conv2d's parameters (``weight`` (out, in, kh, kw)[, ``bias``])
    with torch's default init U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn
    from ``generator``; stride 1, explicit (h, w) padding; full float32 on
    the card (``_full_fp32_convs``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: tuple[int, int], *,
                 bias: bool = True, padding=((0, 0), (0, 0)), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        _full_fp32_convs(device)
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel,
                                               device=device))
        k = 1.0 / math.sqrt(in_ch * kernel[0] * kernel[1])
        uniform_(self.weight, k, generator)
        if bias:
            self.bias = nn.Parameter(torch.empty(out_ch, device=device))
            uniform_(self.bias, k, generator)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.padding)


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, groups: int = 1,
           padding=(0, 0)) -> torch.Tensor:
    """NCL conv with OIL weights, ``groups`` and explicit (left, right)
    padding (``lax.conv_general_dilated`` in the JAX package, cuDNN
    here), in the promoted dtype of input and weight."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    if padding[0] != padding[1]:
        x = F.pad(x, tuple(padding))
        padding = (0, 0)
    return F.conv1d(x.to(dt), weight.to(dt),
                    None if bias is None else bias.to(dt),
                    padding=padding[0], groups=groups)


def _full_fp32_convs(device) -> None:
    """float32 means float32 here, as for the port's matrix products (whose
    TF32 is off by default): a convolution built on a CUDA device turns off
    cuDNN's TF32 (``torch.backends.cudnn.allow_tf32``, on by default) for
    the process, since a convolution's backward reads the flag when it
    runs."""
    if device is not None and torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False


class Conv1d(nn.Module):
    """nn.Conv1d's parameters (``weight`` (out, in/groups, k), ``bias``)
    with torch's default init U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn
    from ``generator``; stride 1, explicit (left, right) padding; full
    float32 on the card, as ``Conv2d``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *,
                 groups: int = 1, padding=(0, 0), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        _full_fp32_convs(device)
        self.groups, self.padding = groups, padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups,
                                               kernel, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))
        k = 1.0 / math.sqrt(in_ch // groups * kernel)
        uniform_(self.weight, k, generator)
        uniform_(self.bias, k, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.weight, self.bias, self.groups, self.padding)


class PReLU(nn.Module):
    """nn.PReLU with one shared slope ``weight`` (1,), initialised to
    0.25 as torch does."""

    def __init__(self, init: float = 0.25, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prelu(x, self.weight)
