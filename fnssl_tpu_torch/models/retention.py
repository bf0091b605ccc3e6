"""Multi-scale retention (RetNet) with three equivalent execution modes
(port of ``fnssl_tpu/models/retention.py``).

Parity: IPDnet2/arch/base/retention.py: parallel (:160-172), per-step
recurrent with a rescaled kv state (:174-192), and chunkwise recurrent
with the cross-chunk scale alignment (:194-255); the RetNetRelPos decay
and rotary tables (:36-104); xpos ``theta_shift`` (:107-116).

The products are plain matrix products, as the JAX package leaves them
to XLA; the chunkwise mode's recurrence is a Python loop over chunks (the
JAX package's ``lax.scan`` over chunks), not over steps. The tables are
made on the host in float64 and handed over as float32 tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fnssl_tpu_torch.models.layers import Params, matmul, uniform_


def rms_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


class RetNetRelPos:
    """Decay and rotary tables, made on the host; ``__call__`` returns
    float32 tensors on ``device``."""

    def __init__(self, embed_dim: int, num_heads: int,
                 recurrent_chunk_size: int, decay=None):
        angle = 1.0 / (10000 ** np.linspace(0, 1,
                                            embed_dim // num_heads // 2))
        self.angle = np.repeat(angle, 2)
        if decay is False:
            decays = [1.0] * num_heads
        elif isinstance(decay, (list, tuple)):
            if isinstance(decay[0], float):
                decays = list(decay)
            else:
                decays = [1 - 2.0 ** (-d) for d in decay]
        else:
            d0 = 5 if (decay is None or decay is True) else decay
            decays = (1 - 2.0 ** (-d0 - np.arange(num_heads,
                                                  dtype=np.float64)))
        self.decays = list(np.asarray(decays, np.float64))
        self.decay = np.log(np.asarray(self.decays, np.float32))
        self.recurrent_chunk_size = recurrent_chunk_size

    def __call__(self, slen: int, activate_recurrent: bool = False,
                 chunkwise_recurrent: bool = False, device=None):
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        if activate_recurrent:
            return ((f32(np.sin(self.angle * (slen - 1))),
                     f32(np.cos(self.angle * (slen - 1)))),
                    f32(np.exp(self.decay)))
        index = np.arange(slen)
        sin = np.sin(index[:, None] * self.angle[None, :]).astype(np.float32)
        cos = np.cos(index[:, None] * self.angle[None, :]).astype(np.float32)
        if chunkwise_recurrent:
            cs = self.recurrent_chunk_size
            bi = np.arange(cs, dtype=np.float64)
            tri = np.tril(np.ones((cs, cs)))
            diffs = np.where(tri > 0, bi[:, None] - bi[None, :], np.inf)
            mask = np.exp(diffs[None] * self.decay[:, None, None]
                          .astype(np.float64))
            mask = np.nan_to_num(mask)
            value_inner_decay = (mask[:, -1]
                                 / mask[:, -1].sum(-1, keepdims=True))
            value_inner_decay = value_inner_decay[:, :, None]
            scale = np.sqrt(mask.sum(-1, keepdims=True))
            inner_mask = mask / scale
            cross_decay = np.exp(self.decay.astype(np.float64) * cs)
            query_inner_decay = np.exp(
                self.decay[:, None].astype(np.float64) * (bi + 1))
            query_inner_decay = query_inner_decay[:, :, None] / (
                scale / mask[:, -1].sum(-1)[:, None, None])
            return ((f32(sin), f32(cos)),
                    (f32(inner_mask), f32(cross_decay[:, None, None]),
                     f32(query_inner_decay), f32(value_inner_decay)))
        tri = np.tril(np.ones((slen, slen)))
        diffs = np.where(tri > 0,
                         index[:, None] - index[None, :], np.inf)
        mask = np.exp(diffs[None] * self.decay[:, None, None]
                      .astype(np.float64))
        mask = np.nan_to_num(mask)
        mask = mask / np.sqrt(mask.sum(-1, keepdims=True))
        return (f32(sin), f32(cos)), f32(mask)


def _rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def theta_shift(x: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor) -> torch.Tensor:
    """xpos rotary. Takes (T, kd) tables (parallel/chunkwise), (kd,)
    single-step values (recurrent) or one step's values a row, (B or 1,
    1, 1, kd); the full-vector rotary in every mode, as the JAX package
    applies it, so that the three modes agree."""
    if sin.ndim == 1:
        return x * cos + _rotate_every_two(x) * sin
    slen = x.shape[-2]
    return x * cos[..., :slen, :] + _rotate_every_two(x) * sin[..., :slen, :]


class RetentionConfig(NamedTuple):
    embed_dim: int
    num_heads: int
    value_factor: int = 2
    share_qk: bool = False
    look_ahead: int = 0

    @property
    def value_dim(self):
        return self.embed_dim * self.value_factor

    @property
    def head_dim(self):
        return self.value_dim // self.num_heads

    @property
    def key_dim(self):
        return self.embed_dim // self.num_heads


class Retention(nn.Module):
    """MultiScaleRetention's state dict (``q_proj``, ``k_proj`` unless
    ``share_qk``, ``v_proj``, ``g_proj``, ``out_proj``; no biases),
    xavier-uniform with the JAX package's gains, drawn from
    ``generator``."""

    def __init__(self, cfg: RetentionConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        e, v = cfg.embed_dim, cfg.value_dim
        shapes = {"q_proj": ((e, e), 2 ** -2.5), "k_proj": ((e, e), 2 ** -2.5),
                  "v_proj": ((v, e), 2 ** -2.5), "g_proj": ((v, e), 2 ** -2.5),
                  "out_proj": ((e, v), 2 ** -1)}
        if cfg.share_qk:
            del shapes["k_proj"]
        for name, (shape, gain) in shapes.items():
            setattr(self, name, Params(device, weight=shape))
            std = gain * math.sqrt(2.0 / (shape[0] + shape[1]))
            uniform_(getattr(self, name).weight, math.sqrt(3.0) * std,
                     generator)
        # the recurrent step's rotary angles and decays (RetNetRelPos's),
        # made once on the host (not in the state dict)
        rel = RetNetRelPos(cfg.embed_dim, cfg.num_heads, 1)
        for name, table in (("angle", rel.angle),
                            ("decay", np.exp(rel.decay))):
            self.register_buffer(name, torch.as_tensor(
                table, dtype=torch.float32, device=device), persistent=False)


def _qkvg(p: Retention, x, sin, cos, rope: bool):
    cfg = p.cfg
    bsz, tgt_len, _ = x.shape
    q = matmul(x, p.q_proj.weight.T)
    v = matmul(x, p.v_proj.weight.T)
    g = matmul(x, p.g_proj.weight.T)
    q = q.reshape(bsz, tgt_len, cfg.num_heads, cfg.key_dim
                  ).permute(0, 2, 1, 3)
    if cfg.share_qk:
        k = q
    else:
        k = matmul(x, p.k_proj.weight.T) * cfg.key_dim ** -0.5
        k = k.reshape(bsz, tgt_len, cfg.num_heads, cfg.key_dim
                      ).permute(0, 2, 1, 3)
    qr = theta_shift(q, sin, cos) if rope else q
    kr = theta_shift(k, sin, cos) if rope else k
    return qr, kr, v, g


def _pad_time(t: torch.Tensor, axis: int, before: int, after: int):
    pad = [0, 0] * (t.ndim - 1 - axis) + [before, after]
    return F.pad(t, pad)


def _output(p: Retention, out: torch.Tensor, g: torch.Tensor,
            bsz: int, tgt_len: int) -> torch.Tensor:
    out = rms_norm(out).reshape(bsz, tgt_len, -1)
    out = F.silu(g) * out
    return matmul(out, p.out_proj.weight.T)


def retention_parallel(p: Retention, x, rel_pos, rope: bool = True):
    """Parallel mode (retention.py:160-172)."""
    cfg = p.cfg
    (sin, cos), mask = rel_pos
    bsz, tgt_len, _ = x.shape
    qr, kr, v, g = _qkvg(p, x, sin, cos, rope)
    if cfg.look_ahead > 0:
        la = cfg.look_ahead
        kr = _pad_time(kr, 2, 0, la)
        v = _pad_time(v, 1, 0, la)
        qr = _pad_time(qr, 2, la, 0)
    vr = v.reshape(bsz, v.shape[1], cfg.num_heads, cfg.head_dim
                   ).permute(0, 2, 1, 3)
    qk = matmul(qr, kr.transpose(-1, -2)) * mask
    denom = qk.abs().sum(dim=-1, keepdim=True).clamp(1.0, 5e4)
    out = matmul(qk / denom, vr).permute(0, 2, 1, 3)
    if cfg.look_ahead > 0:
        out = out[:, :-cfg.look_ahead]
    return _output(p, out, g, bsz, tgt_len)


def retention_recurrent_step(p: Retention, x, rel_pos,
                             state: dict | None, rope: bool = True):
    """Single-frame recurrent mode (retention.py:174-192). ``state``:
    {'prev_key_value': (b, h, kd, hd), 'scale': (h,) or one a row (b, h)}
    or None. Returns (out, new state)."""
    cfg = p.cfg
    (sin, cos), decay = rel_pos
    bsz = x.shape[0]
    h, kd, hd = cfg.num_heads, cfg.key_dim, cfg.head_dim
    qr, kr, v, g = _qkvg(p, x, sin, cos, rope)
    # kv[b,h,kd,hd] = kr[b,h,0,kd]·v[b,h,hd] (retention.py:176-178)
    kv = kr.reshape(bsz, h, kd, 1) * v.reshape(bsz, h, 1, hd)
    if state is not None and "prev_key_value" in state:
        prev_kv, prev_scale = state["prev_key_value"], state["scale"]
        scale = prev_scale * decay + 1
        kv = (prev_kv * (torch.sqrt(prev_scale) * decay
                         / torch.sqrt(scale)).reshape(-1, h, 1, 1)
              + kv / torch.sqrt(scale).reshape(-1, h, 1, 1))
    else:
        scale = torch.ones_like(decay)
    out = (qr.reshape(bsz, h, kd, 1) * kv).sum(dim=2)   # (b, h, hd)
    return (_output(p, out, g, bsz, 1),
            {"prev_key_value": kv, "scale": scale})


def retention_chunkwise(p: Retention, x, rel_pos, rope: bool = True):
    """Chunkwise-recurrent mode (retention.py:194-255): the products
    within a chunk in parallel, the kv state carried from chunk to chunk
    with its running scale (``kv_scale``) rescaling the cross-chunk
    output."""
    cfg = p.cfg
    (sin, cos), (mask, cross_decay, query_inner_decay,
                 value_inner_decay) = rel_pos
    bsz, tgt_len0, _ = x.shape
    qr, kr, v, g = _qkvg(p, x, sin, cos, rope)
    if cfg.look_ahead > 0:
        la = cfg.look_ahead
        kr = _pad_time(kr, 2, 0, la)
        v = _pad_time(v, 1, 0, la)
        qr = _pad_time(qr, 2, la, 0)
    tgt_len = v.shape[1]
    chunk_len = mask.shape[1]
    pad = (-tgt_len) % chunk_len
    if pad:
        qr = _pad_time(qr, 2, 0, pad)
        kr = _pad_time(kr, 2, 0, pad)
        v = _pad_time(v, 1, 0, pad)
    padded_len = v.shape[1]
    nchunk = padded_len // chunk_len
    h, kd, hd = cfg.num_heads, cfg.key_dim, cfg.head_dim
    qr = qr.reshape(bsz, h, nchunk, chunk_len, kd).permute(0, 2, 1, 3, 4)
    kr = kr.reshape(bsz, h, nchunk, chunk_len, kd).permute(0, 2, 1, 3, 4)
    v = v.reshape(bsz, nchunk, chunk_len, h, hd).permute(0, 1, 3, 2, 4)

    kr_t = kr.transpose(-1, -2)
    qk = matmul(qr, kr_t) * mask
    inner_scale = qk.abs().sum(dim=-1, keepdim=True).clamp(min=1.0)
    inner_output = matmul(qk / inner_scale, v)
    kv = matmul(kr_t, v * value_inner_decay)     # (b, nchunk, h, kd, hd)

    kv_state = kv.new_zeros((bsz, h, kd, hd))
    kv_scale = kv.new_ones((bsz, h, 1, 1))
    kv_rec, cross_scale = [], []
    for i in range(nchunk):
        kv_rec.append(kv_state / kv_scale)
        cross_scale.append(kv_scale)
        kv_state = kv_state * cross_decay + kv[:, i]
        kv_scale = kv_state.abs().sum(dim=-2, keepdim=True).amax(
            dim=-1, keepdim=True).clamp(min=1.0)
    kv_rec = torch.stack(kv_rec, dim=1)
    cross_scale = torch.stack(cross_scale, dim=1)

    all_scale = torch.maximum(inner_scale, cross_scale)
    cross_output = matmul(qr * query_inner_decay, kv_rec)
    output = (inner_output / (all_scale / inner_scale)
              + cross_output / (all_scale / cross_scale))
    output = output.transpose(2, 3)           # (b, nchunk, chunk, h, hd)
    output = output.reshape(bsz, padded_len, h, hd)
    output = output[:, :tgt_len0 + max(cfg.look_ahead, 0)]
    if cfg.look_ahead > 0:
        output = output[:, :-cfg.look_ahead]
    return _output(p, output, g, bsz, tgt_len0)
