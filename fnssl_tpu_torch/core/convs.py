"""Spherical padding and causal convolution blocks (port of
``fnssl_tpu/core/convs.py``; parity: FN-SSL/Module.py:745-865).

SphericPad (replicate time, reflect elevation, circular azimuth),
CausConv1d/2d/3d (left-causal time padding) and CausCnnBlock (a residual
conv block with causal width padding), the reference's SRP-map CNN
utilities, as functions of a flat state dict under the reference's names
(``weight``, ``bias``, ``conv1.weight``, ``bn1.bias``, …):
``train.convert.params_to_state_dict`` turns the JAX package's parameter
pytree into one.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]


def spheric_pad(x: torch.Tensor, pad) -> torch.Tensor:
    """pad = (left, right, top, bottom[, front, back]) for the
    (azimuth, elevation[, time]) trailing axes: circular on azimuth (the
    last axis), reflect on elevation (second-last), replicate on time
    (third-last, optional)."""
    if len(pad) == 4:
        left, right, top, bottom = pad
        front = back = 0
    elif len(pad) == 6:
        left, right, top, bottom, front, back = pad
    else:
        raise ValueError("pad must have 4 or 6 entries")
    if x.shape[-1] < max(left, right):
        raise ValueError(f"circular pad ({left}, {right}) wider than the "
                         f"azimuth axis ({x.shape[-1]})")
    if front > 0 or back > 0:
        x = torch.cat([x[..., :1, :, :].expand(
                           *x.shape[:-3], front, *x.shape[-2:]), x,
                       x[..., -1:, :, :].expand(
                           *x.shape[:-3], back, *x.shape[-2:])], dim=-3)
    if top > 0 or bottom > 0:
        h = x.shape[-2]
        x = torch.cat([x[..., 1:top + 1, :].flip(-2), x,
                       x[..., h - 1 - bottom:h - 1, :].flip(-2)], dim=-2)
    if left > 0 or right > 0:
        # x[..., -0:] is the whole axis, as in the JAX package
        x = torch.cat([x[..., -left:], x, x[..., :right]], dim=-1)
    return x


def caus_conv1d(params: Params, x: torch.Tensor,
                dilation: int = 1) -> torch.Tensor:
    """Causal conv over the last axis. x: (B, C, T); weight (O, I, K)."""
    k = params["weight"].shape[-1]
    x = F.pad(x, ((k - 1) * dilation, 0))
    return F.conv1d(x, params["weight"], params["bias"], dilation=dilation)


def caus_conv2d(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Causal in time (axis 2), valid in the last axis.
    x: (B, C, T, F); weight (O, I, Kt, Kf)."""
    kt = params["weight"].shape[2]
    return F.conv2d(F.pad(x, (0, 0, kt - 1, 0)), params["weight"],
                    params["bias"])


def caus_conv3d(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Causal in time (axis 2) for SRP-map sequences.
    x: (B, C, T, E, A); weight (O, I, Kt, Ke, Ka)."""
    kt = params["weight"].shape[2]
    return F.conv3d(F.pad(x, (0, 0, 0, 0, kt - 1, 0)), params["weight"],
                    params["bias"])


def batch_norm_2d(params: Params, x: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Batch statistics of this batch over (B, H, W) per channel (no
    running statistics)."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    return (out * params["weight"].reshape(1, -1, 1, 1)
            + params["bias"].reshape(1, -1, 1, 1))


def _sub(params: Params, prefix: str) -> dict[str, torch.Tensor]:
    """The entries of ``params`` under ``prefix.``, the prefix dropped."""
    head = prefix + "."
    return {k[len(head):]: v for k, v in params.items()
            if k.startswith(head)}


def caus_cnn_block(params: Params, x: torch.Tensor, padding=(1, 2),
                   use_res: bool = True) -> torch.Tensor:
    """Residual causal conv block (Module.py:827-865). x: (B, C, H, W);
    params: conv1/bn1/conv2/bn2 (and an optional downsample conv)."""
    def conv(name, inp, pad=tuple(padding)):
        sub = _sub(params, name)
        return F.conv2d(inp, sub["weight"], sub.get("bias"), padding=pad)

    out = torch.relu(batch_norm_2d(_sub(params, "bn1"), conv("conv1", x)))
    if padding[1]:
        out = out[..., :-padding[1]]
    out = batch_norm_2d(_sub(params, "bn2"), conv("conv2", out))
    if padding[1]:
        out = out[..., :-padding[1]]
    if use_res:
        residual = x
        if "downsample.weight" in params:
            residual = conv("downsample", x, (0, 0))
        out = out + residual
    return torch.relu(out)
