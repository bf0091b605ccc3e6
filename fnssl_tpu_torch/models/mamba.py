"""Mamba (S6 selective state space) block of IPDnet2 (port of
``fnssl_tpu/models/mamba.py``), the slot of the reference's ``mamba_ssm``
CUDA package (IPDnet2/IPDnet2.py:16-19).

  * ``mamba_step``: a chunk forward with the explicit (conv tail, SSM
    state) carry; ``mamba_apply``: the full sequence from zero state, the
    JAX package's default sequential path (the same chunk forward); its
    ``use_associative`` variant runs the same path.
  * The selective scan runs in ``SSMScan``, a ``torch.autograd.Function``
    over the fused pair (mamba_ssm's ``selective_scan`` contract): it takes
    x, dt (the dt_proj product before bias and softplus), dt_bias, A, B,
    C, D and h0, forms exp(Δ·A) and Δ·x·B in registers, and keeps only
    its inputs for the backward: forward K3 (through the custom op
    ``kernels.ops.selective_scan_fwd``, which ``torch.export`` traces as
    one node) and backward K4 (``kernels.ssm_cuda``) for CUDA tensors,
    their plain versions for CPU ones. The JAX package's ``_ssm_inputs``
    materialises both (B, L, d, n) tensors; here no path does. The
    projections around it are torch matrix products, as the JAX package
    leaves them to XLA.

Parameter names follow mamba_ssm's state_dict (in_proj, conv1d, x_proj,
dt_proj, A_log, D, out_proj), so converted checkpoints load strictly.
Defaults match mamba_ssm.Mamba: expand 2, dt_rank ceil(d_model/16), dt
init by the S4D rules; the weights are drawn from a torch generator.

Dtypes follow JAX's promotion: the carried conv tail and SSM state are
float32, so under the bf16 policy the conv output, the scan's inputs and
the block's output are float32 (the caller casts back).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from fnssl_tpu_torch.kernels.ops import selective_scan_fwd
from fnssl_tpu_torch.kernels.ssm_cuda import selective_scan_bwd
from fnssl_tpu_torch.models.layers import Params, matmul, uniform_


class MambaConfig(NamedTuple):
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_inner, d_conv-1) last inputs to the conv
    ssm: torch.Tensor   # (B, d_inner, d_state)


def init_mamba_state(batch: int, cfg: MambaConfig, device=None
                     ) -> MambaState:
    return MambaState(
        torch.zeros((batch, cfg.d_inner, cfg.d_conv - 1), device=device),
        torch.zeros((batch, cfg.d_inner, cfg.d_state), device=device))


class Mamba(nn.Module):
    """mamba_ssm.Mamba's parameters, initialised as the JAX package's
    ``init_mamba_params`` (its rules, drawn from ``generator``)."""

    def __init__(self, cfg: MambaConfig, *, device=None,
                 generator: torch.Generator | None = None,
                 dt_min: float = 1e-3, dt_max: float = 0.1,
                 dt_init_floor: float = 1e-4):
        super().__init__()
        self.cfg = cfg
        di, dm, dr, n = cfg.d_inner, cfg.d_model, cfg.dt_rank, cfg.d_state
        self.in_proj = Params(device, weight=(2 * di, dm))
        self.conv1d = Params(device, weight=(di, 1, cfg.d_conv), bias=(di,))
        self.x_proj = Params(device, weight=(dr + 2 * n, di))
        self.dt_proj = Params(device, weight=(di, dr), bias=(di,))
        self.A_log = nn.Parameter(torch.empty((di, n), device=device))
        self.D = nn.Parameter(torch.ones((di,), device=device))
        self.out_proj = Params(device, weight=(dm, di))
        uniform_(self.in_proj.weight, 1.0 / math.sqrt(dm), generator)
        uniform_(self.conv1d.weight, 1.0 / math.sqrt(cfg.d_conv), generator)
        uniform_(self.conv1d.bias, 1.0 / math.sqrt(cfg.d_conv), generator)
        uniform_(self.x_proj.weight, 1.0 / math.sqrt(di), generator)
        uniform_(self.dt_proj.weight, dr ** -0.5, generator)
        uniform_(self.out_proj.weight, 1.0 / math.sqrt(di), generator)
        with torch.no_grad():
            # dt_proj bias: inverse softplus of a log-uniform dt
            u = torch.rand((di,), generator=generator)
            dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min))
                           + math.log(dt_min)).clamp(min=dt_init_floor)
            self.dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            a = torch.arange(1, n + 1, dtype=torch.float32)
            self.A_log.copy_(torch.log(a).expand(di, n))

    def forward(self, u: torch.Tensor, state: MambaState | None = None):
        """``mamba_apply`` without a state, ``mamba_step`` with one (then
        returns (out, new state))."""
        if state is None:
            return mamba_apply(self, u)
        return mamba_step(self, u, state)


def _conv_silu(p: Mamba, x: torch.Tensor, tail: torch.Tensor | None):
    """Depthwise causal conv + SiLU, x (B, L, d_inner); ``tail`` (B,
    d_inner, k-1) holds the inputs before x (zeros if None). Returns the
    output and the new tail."""
    w = p.conv1d.weight[:, 0, :]                         # (d, k)
    k = p.cfg.d_conv
    xt = x.transpose(1, 2)                               # (B, d, L)
    pad = (xt.new_zeros(xt.shape[:2] + (k - 1,)) if tail is None else tail)
    dt = torch.promote_types(pad.dtype, xt.dtype)
    xin = torch.cat([pad.to(dt), xt.to(dt)], dim=-1)
    new_tail = xin[..., -(k - 1):]
    steps = x.shape[1]
    out = xin[..., 0:steps] * w[None, :, 0:1]
    for i in range(1, k):
        out = out + xin[..., i: i + steps] * w[None, :, i: i + 1]
    out = out + p.conv1d.bias[None, :, None]
    return F.silu(out.transpose(1, 2)), new_tail


class SSMScan(torch.autograd.Function):
    """The fused selective scan on K3 forward and K4 backward (their plain
    versions for CPU tensors), batch-major: x, dt (B, L, d), dt_bias (d),
    a (d, n), bm, c (B, L, n), d_skip (d), h0 (B, d, n) → y = the scan's
    contraction + D·x (B, L, d), h_last (B, d, n), float32
    (``kernels.ssm_cuda``'s contract). The port's ``ssm_scan`` with
    ``_ssm_inputs`` fused into it; only the inputs are kept for the
    backward, which replays h from them."""

    @staticmethod
    def forward(ctx, x, dt, dt_bias, a, bm, c, d_skip, h0):
        args = tuple(t.contiguous() for t in (x, dt, dt_bias, a, bm, c,
                                              d_skip, h0))
        y, h_last = selective_scan_fwd(*args)
        ctx.save_for_backward(*args)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        return selective_scan_bwd(*ctx.saved_tensors,
                                  dy.float().contiguous(),
                                  dh_last.float().contiguous())


def ssm_scan(x, dt, dt_bias, a, bm, c, d_skip, h0):
    """``SSMScan`` on x, dt, bm, c in their promoted dtype and the
    parameters and state in float32 (JAX's promotion against the float32
    state: the same values)."""
    dt_ = functools.reduce(torch.promote_types,
                           (x.dtype, dt.dtype, bm.dtype, c.dtype))
    return SSMScan.apply(*(t.to(dt_) for t in (x, dt)), dt_bias.float(),
                         a.float(), *(t.to(dt_) for t in (bm, c)),
                         d_skip.float(), h0.float())


def selective_scan(p: Mamba, x: torch.Tensor, h0: torch.Tensor):
    """The block between the conv and the gate: x (B, L, d_inner) silu'd
    conv output, h0 (B, d_inner, n) → y = the scan + D·x (B, L, d_inner)
    and h_last, float32. x_proj and dt_proj stay matrix products; what
    ``_ssm_inputs`` did after them happens inside the scan."""
    dr, n = p.cfg.dt_rank, p.cfg.d_state
    x_dbl = matmul(x, p.x_proj.weight.T)
    delta, b, c = torch.split(x_dbl, [dr, n, n], dim=-1)
    dt = matmul(delta, p.dt_proj.weight.T)
    a = -torch.exp(p.A_log)                              # (d, n)
    return ssm_scan(x, dt, p.dt_proj.bias, a, b, c, p.D, h0)


def mamba_step(p: Mamba, u: torch.Tensor, state: MambaState
               ) -> tuple[torch.Tensor, MambaState]:
    """Chunk forward with carry. u: (B, L, d_model)."""
    xz = matmul(u, p.in_proj.weight.T)
    x, z = xz.chunk(2, dim=-1)
    x, conv_tail = _conv_silu(p, x, state.conv)
    y, h_last = selective_scan(p, x, state.ssm)
    y = y * F.silu(z)
    return matmul(y, p.out_proj.weight.T), MambaState(conv_tail, h_last)


def mamba_apply(p: Mamba, u: torch.Tensor,
                use_associative: bool = False) -> torch.Tensor:
    """Full-sequence forward from zero state, u: (B, L, d_model) → (B, L,
    d_model): ``mamba_step`` from ``init_mamba_state``, so K3 for CUDA
    tensors. ``use_associative`` names the JAX package's log-depth
    variant of the same recurrence; it is accepted for its callers and
    runs this same path, since K3 computes the same function."""
    del use_associative
    out, _ = mamba_step(p, u, init_mamba_state(u.shape[0], p.cfg, u.device))
    return out
