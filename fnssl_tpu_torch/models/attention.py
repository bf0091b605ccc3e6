"""MHSA time module, causal attention masks, and the T-ConvFFN block of
IPDnet2 (port of ``fnssl_tpu/models/attention.py``).

  * ``MHSA``: ``nn.MultiheadAttention(batch_first=True)``'s parameters
    (``in_proj_weight``, ``in_proj_bias``, ``out_proj.*``), driven by an
    additive causal mask (IPDnet2/IPDnet2.py:183-202);
  * ``causal_mask``: the bounded look-back window of ``attn_scope`` frames
    of ``get_causal_mask`` (IPDnet2.py:370-399), optionally with ALiBi's
    per-head linear decay (slope 2^(-8/h), h = 1..H);
  * ``TConvFFN``: the conv feed-forward branch used when the second time
    module is not Mamba: LN → 1x1 expand → SiLU → grouped causal conv →
    SiLU → 1x1 project, under ModuleList indices "0", "1", "3", "5".

The scores are plain matrix products over the nb·nf narrow-band
sequences, as the JAX package leaves them to XLA. Streaming carries the
last ``attn_scope - 1`` inputs and recomputes their K/V each chunk: the
mask never lets a query see further back, so the chunked result equals
the one-shot one.

Dtypes follow JAX's promotion: the float32 mask (and a streaming state's
float32 tail) promote a bfloat16 computation to float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fnssl_tpu_torch.models.layers import (Conv1d, LayerNorm, Params, conv1d,
                                          matmul, uniform_)


class MHSAConfig(NamedTuple):
    embed_dim: int
    num_heads: int
    attn_scope: int = 251     # 'mhsa(frames)' (IPDnet2.py:276)
    alibi: bool = False       # rope == 'ALiBi' (IPDnet2.py:372-377)


def alibi_slopes(num_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes 2^(-8/h), h = 1..H (IPDnet2.py:372)."""
    return 2.0 ** (-8.0 / np.arange(1, num_heads + 1))


def causal_mask(slen: int, attn_scope: int, num_heads: int | None = None,
                alibi: bool = False) -> np.ndarray:
    """Additive attention mask of ``get_causal_mask`` (IPDnet2.py:381-399).

    A key is visible iff 0 <= i - j < attn_scope. Plain: (slen, slen) of
    {0, -inf}. ALiBi: (num_heads, slen, slen) with slope_h · -(i - j) on
    visible entries.
    """
    idx = np.arange(slen)
    rel = idx[:, None] - idx[None, :]
    visible = (rel >= 0) & (rel < attn_scope)
    if alibi:
        m = alibi_slopes(num_heads).reshape(num_heads, 1, 1)
        return np.where(visible, m * -np.abs(rel), -np.inf).astype(np.float32)
    return np.where(visible, 0.0, -np.inf).astype(np.float32)


class MHSA(nn.Module):
    """``nn.MultiheadAttention``'s state dict, initialised as the JAX
    package's ``init_mhsa_params``: xavier-uniform ``in_proj_weight``,
    zero biases, Linear-default ``out_proj.weight`` (drawn from
    ``generator``)."""

    def __init__(self, cfg: MHSAConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.in_proj_weight = nn.Parameter(torch.empty((3 * e, e),
                                                       device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros((3 * e,),
                                                     device=device))
        self.out_proj = Params(device, weight=(e, e), bias=(e,))
        uniform_(self.in_proj_weight, math.sqrt(6.0 / (4 * e)), generator)
        uniform_(self.out_proj.weight, math.sqrt(3.0 / e), generator)
        # the streaming step's ALiBi slopes, made once on the host (not in
        # the state dict)
        self.register_buffer("alibi", torch.as_tensor(
            alibi_slopes(cfg.num_heads), dtype=torch.float32,
            device=device), persistent=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                state: "MHSAState | None" = None):
        """``mhsa_apply`` with a mask, ``mhsa_apply_streaming`` with a
        state (then returns (out, new state))."""
        if state is None:
            return mhsa_apply(self, x, mask)
        return mhsa_apply_streaming(self, x, state)


def _qkv(p: MHSA, x_q: torch.Tensor, x_kv: torch.Tensor):
    e, h = p.cfg.embed_dim, p.cfg.num_heads
    hd = e // h
    w, b = p.in_proj_weight, p.in_proj_bias
    q = matmul(x_q, w[:e].T) + b[:e]
    k = matmul(x_kv, w[e:2 * e].T) + b[e:2 * e]
    v = matmul(x_kv, w[2 * e:].T) + b[2 * e:]

    def heads(t):
        bsz, tl, _ = t.shape
        return t.reshape(bsz, tl, h, hd).permute(0, 2, 1, 3)

    return heads(q) * hd ** -0.5, heads(k), heads(v)


def _attend(p: MHSA, q, k, v, mask: torch.Tensor) -> torch.Tensor:
    bsz = q.shape[0]
    scores = matmul(q, k.transpose(-1, -2)) + mask     # (B, h, Tq, Tk)
    out = matmul(torch.softmax(scores, dim=-1), v)     # (B, h, Tq, hd)
    out = out.permute(0, 2, 1, 3).reshape(bsz, q.shape[2], -1)
    return matmul(out, p.out_proj.weight.T) + p.out_proj.bias


def mhsa_apply(p: MHSA, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One-shot self-attention on (B, T, H) with an additive mask ((T, T)
    or (heads, T, T)), numerically ``nn.MultiheadAttention``'s."""
    q, k, v = _qkv(p, x, x)
    return _attend(p, q, k, v, torch.as_tensor(mask, device=x.device))


class MHSAState(NamedTuple):
    tail: torch.Tensor  # (B, attn_scope-1, H) last window of inputs
    pos: torch.Tensor   # () or (B,) int32, frames consumed so far


def init_mhsa_state(batch: int, cfg: MHSAConfig, device=None,
                    per_row: bool = False) -> MHSAState:
    """JAX's state (``pos`` a scalar), or with ``per_row`` one position a
    row, so that rows at different positions (a slot pool's) share a
    batch."""
    return MHSAState(
        torch.zeros((batch, max(cfg.attn_scope - 1, 0), cfg.embed_dim),
                    device=device),
        torch.zeros((batch,) if per_row else (), dtype=torch.int32,
                    device=device))


def mhsa_apply_streaming(p: MHSA, x: torch.Tensor, state: MHSAState):
    """Chunked streaming attention, equal to the one-shot path: the last
    ``attn_scope - 1`` raw inputs are carried and their K/V recomputed
    each chunk. ``state.pos`` is one position for the batch or one a row;
    either way ``real`` is a (B or 1, 1, 1, w+T) mask, so equal rows give
    the scalar form's bits. The mask is built on the device from aranges
    and the ALiBi slopes buffer: no host copy, so the step can be captured
    in a CUDA graph. Returns (out, new state)."""
    cfg = p.cfg
    t = x.shape[1]
    w = max(cfg.attn_scope - 1, 0)
    dt = torch.promote_types(state.tail.dtype, x.dtype)
    ctx = torch.cat([state.tail.to(dt), x.to(dt)], dim=1)   # (B, w+T, H)
    q, k, v = _qkv(p, x, ctx)
    # query i attends ctx j: rel = i + w - j; visible iff 0 <= rel < scope
    # and ctx j is a real frame (its global index pos - w + j >= 0)
    j = torch.arange(w + t, device=x.device)
    rel = torch.arange(t, device=x.device)[:, None] + w - j
    visible = (rel >= 0) & (rel < cfg.attn_scope)
    real = (state.pos.reshape(-1, 1, 1, 1) - w + j) >= 0   # (B or 1, …)
    if cfg.alibi:
        base = p.alibi[:, None, None] * (-rel.abs()).float()
    else:
        base = torch.zeros(rel.shape, device=x.device)
    mask = torch.where(visible & real, base,
                       torch.full_like(base, -torch.inf))
    out = _attend(p, q, k, v, mask)
    new_tail = ctx[:, ctx.shape[1] - w:] if w else state.tail
    return out, MHSAState(new_tail, state.pos + t)


# ---------------------------------------------------------------------------
# T-ConvFFN (the non-Mamba second time module)


class TConvFFNConfig(NamedTuple):
    dim_hidden: int
    kernel_size: int = 3      # kernel_size[1] of the reference layer args
    groups: int = 8           # conv_groups[1]
    factor: int = 2           # hidden expansion


class TConvFFN(nn.ModuleDict):
    """``ModuleList([LayerNorm, Conv1d, SiLU, CausalConv1d, SiLU,
    Conv1d])``'s parameters under its indices "0", "1", "3", "5"
    (IPDnet2.py:204-221); convs with torch's default init from
    ``generator``."""

    def __init__(self, cfg: TConvFFNConfig, *, device=None,
                 generator: torch.Generator | None = None):
        h, hf, k = cfg.dim_hidden, cfg.dim_hidden * cfg.factor, \
            cfg.kernel_size
        kw = dict(device=device, generator=generator)
        super().__init__({
            "0": LayerNorm(h, device=device),
            "1": Conv1d(h, hf, 1, **kw),
            "3": Conv1d(hf, hf, k, groups=cfg.groups, **kw),
            "5": Conv1d(hf, h, 1, **kw)})
        self.cfg = cfg

    def forward(self, x: torch.Tensor, state: torch.Tensor | None = None):
        return tconvffn_apply(self, x, state)


def tconvffn_apply(p: TConvFFN, x: torch.Tensor,
                   state: torch.Tensor | None = None):
    """x: (B, T, H) → (B, T, H); with ``state``, the causal conv's tail
    (B, H·factor, k-1) is carried (CausalConv1d semantics,
    IPDnet2.py:66-76) and (out, new tail) returned."""
    cfg = p.cfg
    y = p["0"](x).transpose(1, 2)                    # (B, H, T)
    y = F.silu(p["1"](y))
    c3, k = p["3"], cfg.kernel_size
    if state is None:
        y = F.silu(conv1d(y, c3.weight, c3.bias, cfg.groups, (k - 1, 0)))
        new_state = None
    else:
        dt = torch.promote_types(state.dtype, y.dtype)
        yin = torch.cat([state.to(dt), y.to(dt)], dim=-1)
        new_state = yin[..., yin.shape[-1] - (k - 1):]
        y = F.silu(conv1d(yin, c3.weight, c3.bias, cfg.groups))
    out = p["5"](y).transpose(1, 2)
    return (out, new_state) if state is not None else out


def init_tconvffn_state(batch: int, cfg: TConvFFNConfig,
                        device=None) -> torch.Tensor:
    return torch.zeros((batch, cfg.dim_hidden * cfg.factor,
                        cfg.kernel_size - 1), device=device)
