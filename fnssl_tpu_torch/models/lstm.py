"""LSTM with ``nn.LSTM``'s parameters on the hand-written recurrence
(port of ``fnssl_tpu/models/lstm.py`` and of ``lstm_fused_scan``'s custom
VJP in ``fnssl_tpu/kernels/lstm_pallas.py``).

Forward (``LSTMRecurrence.forward``), for one direction or both
directions of a BiLSTM stacked in front (ndir = 1 or 2):

  1. The input projection ``xg = x @ W_ihᵀ + (b_ih + b_hh)`` is one large
     ``torch.matmul`` against the stacked W_ihᵀ (I, ndir·4H) outside the
     kernel (the JAX package leaves it to XLA); the two biases are summed
     first, so autograd gives both the same gradient, as torch does.
  2. Only the hidden recurrence runs in ``kernels.lstm_cuda``, reached
     through the custom ops of ``kernels.ops`` (so that ``torch.export``
     traces it as one node): one launch of K1 (``lstm_fwd``, or
     ``lstm_fwd_bidir`` for both directions, whose backward direction walks
     the unflipped x from T-1 to 0) for CUDA tensors, the plain version for
     CPU ones. Only x, ys, h0, c0 and the weights are kept for the
     backward; xg is not.

Backward (``LSTMRecurrence.backward``), the recompute-in-backward of
``_lstm_backward``:

  1. G = x @ W_ihᵀ + b + h_prev @ W_hhᵀ is recomputed by matrix products
     into one (ndir, T, B, 4H) float32 buffer (h_prev is h0 at the first
     walk step, else ys at the walk's previous step).
  2. One launch of K2 (``lstm_bwd``/``lstm_bwd_bidir``) replays c and
     walks back, turning G into dgates in place and giving dh0, dc0.
  3. dx, dW_ih, dW_hh and db are large matrix products and sums of dgates.

Parameter names are ``nn.LSTM``'s: weight_ih_l0 (4H, I), weight_hh_l0
(4H, H), bias_ih_l0, bias_hh_l0 [+ ``_reverse`` twins]. Gate order
i, f, g, o.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from fnssl_tpu_torch.kernels.lstm_cuda import lstm_bwd, lstm_bwd_bidir
from fnssl_tpu_torch.kernels.ops import lstm_fwd, lstm_fwd_bidir
from fnssl_tpu_torch.models.layers import uniform_
from fnssl_tpu_torch.utils.device import resolve_device

_NAMES = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")


class LSTMState(NamedTuple):
    """Streaming carry (h, c), each (num_dirs, B, H)."""
    h: torch.Tensor
    c: torch.Tensor


def _input_gates(x, w_ih, bias):
    """x (B, T, I), w_ih (ndir, 4H, I), bias (ndir, 4H) → xg (ndir, T, B,
    4H) in x's dtype: one matrix product for every direction."""
    b, t_steps = x.shape[:2]
    ndir, four_h = w_ih.shape[:2]
    xg = torch.matmul(x, w_ih.reshape(ndir * four_h, -1).T) + bias.reshape(-1)
    return xg.view(b, t_steps, ndir, four_h).permute(2, 1, 0, 3).contiguous()


def _walk_prev(reverse):
    """Indices into a time-major (T, ...) tensor: the steps that have a
    previous step in the walk, those previous steps, and the first step."""
    if reverse:
        return slice(0, -1), slice(1, None), -1
    return slice(1, None), slice(0, -1), 0


class LSTMRecurrence(torch.autograd.Function):
    """One direction (ndir 1, ``reverse`` its walk) or both directions of
    a BiLSTM (ndir 2, direction 1 walking t = T-1 .. 0) on K1 forward and
    K2 backward.

    Inputs: x (B, T, I); w_ih (ndir, 4H, I); w_hh (ndir, 4H, H); bias
    (ndir, 4H) = b_ih + b_hh; h0, c0 (ndir, B, H). Outputs: ys (ndir, T,
    B, H) in x's dtype (time-major), hT, cT (ndir, B, H) float32.
    """

    @staticmethod
    def forward(ctx, x, w_ih, w_hh, bias, h0, c0, reverse=False):
        xg = _input_gates(x, w_ih, bias)
        w_hh_t = w_hh.transpose(1, 2).to(xg.dtype).contiguous()
        h0f, c0f = h0.float().contiguous(), c0.float().contiguous()
        if w_ih.shape[0] == 2:
            ys, h_t, c_t = lstm_fwd_bidir(xg, w_hh_t, h0f, c0f)
        else:
            ys, h_t, c_t = (o[None] for o in lstm_fwd(
                xg[0], w_hh_t[0], h0f[0], c0f[0], reverse=reverse))
        ctx.save_for_backward(x, w_ih, w_hh, bias, h0, c0, ys)
        ctx.reverse = reverse
        return ys, h_t, c_t

    @staticmethod
    def backward(ctx, dys, dh_t, dc_t):
        x, w_ih, w_hh, bias, h0, c0, ys = ctx.saved_tensors
        ndir, t_steps, batch, hidden = ys.shape
        # 1. G in one float32 buffer: the forward's xg, then + h_prev@W_hhᵀ
        g = _input_gates(x, w_ih, bias).float()
        h_first = h0.to(ys.dtype).float()   # h0 passes through ys's dtype
        w_hh_f = w_hh.float()
        walks = [_walk_prev(ctx.reverse or d == 1) for d in range(ndir)]
        for d, (now, prev, first) in enumerate(walks):
            g[d, now].view(-1, 4 * hidden).addmm_(
                ys[d, prev].reshape(-1, hidden).float(), w_hh_f[d].T)
            g[d, first].addmm_(h_first[d], w_hh_f[d].T)
        # 2. K2: dgates over G, dh0, dc0
        args = (g, w_hh.to(ys.dtype).contiguous(), c0.float().contiguous(),
                dys.to(ys.dtype).contiguous(), dh_t.float().contiguous(),
                dc_t.float().contiguous())
        if ndir == 2:
            _, dh0, dc0 = lstm_bwd_bidir(*args)
        else:
            _, dh0, dc0 = (o[None] for o in lstm_bwd(
                *(a[0] for a in args), reverse=ctx.reverse))
        # 3. the weight sums and dx as large products
        rows = g.view(ndir, t_steps * batch, 4 * hidden)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = rows[0] @ w_ih[0].float()
            for d in range(1, ndir):
                dx.addmm_(rows[d], w_ih[d].float())
            dx = dx.view(t_steps, batch, -1).transpose(0, 1).to(x.dtype)
        x_rows = x.transpose(0, 1).reshape(t_steps * batch, -1).float()
        d_wih = torch.stack([rows[d].T @ x_rows for d in range(ndir)])
        d_whh = torch.empty_like(w_hh_f)
        for d, (now, prev, first) in enumerate(walks):
            torch.mm(g[d, now].reshape(-1, 4 * hidden).T,
                     ys[d, prev].reshape(-1, hidden).float(), out=d_whh[d])
            d_whh[d].addmm_(g[d, first].T, h_first[d])
        db = rows.sum(dim=1)
        return (dx, d_wih.to(w_ih.dtype), d_whh.to(w_hh.dtype),
                db.to(bias.dtype), dh0.to(h0.dtype), dc0.to(c0.dtype), None)


def lstm(params, x: torch.Tensor, state: LSTMState | None = None,
         bidirectional: bool = False) -> tuple[torch.Tensor, LSTMState]:
    """Run an LSTM with torch semantics; differentiable through
    ``LSTMRecurrence``.

    Args:
      params: mapping of ``nn.LSTM`` names to tensors.
      x: (B, T, input_size).
      state: optional streaming carry; zeros of x's dtype if None.

    Returns:
      outputs (B, T, H*num_dirs), laid out as ``cat([forward, backward],
      -1)`` when bidirectional, and the final LSTMState in the state's
      dtype.
    """
    b, t_steps = x.shape[:2]
    hidden = params["weight_hh_l0"].shape[1]
    ndir = 2 if bidirectional else 1
    if state is None:
        zeros = x.new_zeros((ndir, b, hidden))
        state = LSTMState(zeros, zeros)
    suffixes = ("", "_reverse")[:ndir]
    w_ih, w_hh, b_ih, b_hh = (torch.stack([params[n + s] for s in suffixes])
                              for n in _NAMES)
    ys, h_t, c_t = LSTMRecurrence.apply(x, w_ih, w_hh, b_ih + b_hh,
                                        state.h, state.c, False)
    if ndir == 1:
        out = ys[0].transpose(0, 1)
    else:
        out = ys.permute(2, 1, 0, 3).reshape(b, t_steps, 2 * hidden)
    return out, LSTMState(h_t.to(state.h.dtype), c_t.to(state.c.dtype))


class LSTM(nn.Module):
    """Single-layer LSTM, batch first, with ``nn.LSTM``'s parameter names
    and torch's default init U(-1/sqrt(H), 1/sqrt(H))."""

    def __init__(self, input_size: int, hidden_size: int,
                 bidirectional: bool = False, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.hidden_size = hidden_size
        self.bidirectional = bidirectional
        shapes = {"weight_ih_l0": (4 * hidden_size, input_size),
                  "weight_hh_l0": (4 * hidden_size, hidden_size),
                  "bias_ih_l0": (4 * hidden_size,),
                  "bias_hh_l0": (4 * hidden_size,)}
        names = list(shapes)
        if bidirectional:
            names += [n + "_reverse" for n in shapes]
        k = 1.0 / math.sqrt(hidden_size)
        for name in names:
            p = nn.Parameter(torch.empty(shapes[name.replace("_reverse", "")],
                                         device=device))
            uniform_(p, k, generator)
            self.register_parameter(name, p)

    def forward(self, x: torch.Tensor, state: LSTMState | None = None
                ) -> tuple[torch.Tensor, LSTMState]:
        return lstm(dict(self.named_parameters()), x, state,
                    self.bidirectional)
