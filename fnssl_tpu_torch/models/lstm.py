"""LSTM with ``nn.LSTM``'s parameters on the hand-written recurrence
(port of ``fnssl_tpu/models/lstm.py``).

  1. The input projection ``xg = x @ W_ihᵀ + (b_ih + b_hh)`` is one large
     ``torch.matmul`` outside the kernel (the JAX package leaves it to
     XLA); the two biases are summed first.
  2. Only the hidden recurrence runs in ``kernels.lstm_cuda``: a Hopper
     kernel for CUDA tensors, its plain version for CPU ones.
  3. Bidirectional projects both directions in one ``torch.matmul``
     against the stacked W_ihᵀ (I, 8H) and runs both recurrences in one
     ``lstm_fwd_bidir`` call (one launch); the backward direction walks
     the unflipped x from T-1 to 0.

Parameter names are ``nn.LSTM``'s: weight_ih_l0 (4H, I), weight_hh_l0
(4H, H), bias_ih_l0, bias_hh_l0 [+ ``_reverse`` twins]. Gate order
i, f, g, o.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from fnssl_tpu_torch.kernels.lstm_cuda import lstm_fwd, lstm_fwd_bidir
from fnssl_tpu_torch.models.layers import uniform_
from fnssl_tpu_torch.utils.device import resolve_device


class LSTMState(NamedTuple):
    """Streaming carry (h, c), each (num_dirs, B, H)."""
    h: torch.Tensor
    c: torch.Tensor


def _forward(x, w_ih, w_hh, b_ih, b_hh, h0, c0):
    """One direction: x (B, T, I) → ys (B, T, H), hT, cT (in h0/c0's
    dtype)."""
    xg = torch.matmul(x, w_ih.T) + (b_ih + b_hh)          # (B, T, 4H)
    xg = xg.transpose(0, 1).contiguous()                  # (T, B, 4H)
    ys, h_t, c_t = lstm_fwd(
        xg, w_hh.T.to(xg.dtype).contiguous(),
        h0.float().contiguous(), c0.float().contiguous())
    return ys.transpose(0, 1), h_t.to(h0.dtype), c_t.to(c0.dtype)


def _bidirectional(params, x, h0, c0):
    """Both directions: x (B, T, I), h0/c0 (2, B, H) → outputs
    (B, T, 2H) laid out as ``cat([forward, backward], -1)``, hT, cT
    (2, B, H) in h0/c0's dtype."""
    def both(name):
        return params[name], params[name + "_reverse"]

    b, t_steps = x.shape[:2]
    hidden = params["weight_hh_l0"].shape[1]
    w_ih = torch.cat(both("weight_ih_l0"))                 # (8H, I)
    bias = torch.cat([bi + bh for bi, bh in zip(both("bias_ih_l0"),
                                                  both("bias_hh_l0"))])
    xg = torch.matmul(x, w_ih.T) + bias                    # (B, T, 8H)
    xg = xg.view(b, t_steps, 2, 4 * hidden).permute(2, 1, 0, 3).contiguous()
    w_hh_t = torch.stack([w.T for w in both("weight_hh_l0")])
    ys, h_t, c_t = lstm_fwd_bidir(
        xg, w_hh_t.to(xg.dtype).contiguous(), h0.float().contiguous(),
        c0.float().contiguous())                           # ys (2, T, B, H)
    out = ys.permute(2, 1, 0, 3).reshape(b, t_steps, 2 * hidden)
    return out, LSTMState(h_t.to(h0.dtype), c_t.to(c0.dtype))


def lstm(params, x: torch.Tensor, state: LSTMState | None = None,
         bidirectional: bool = False) -> tuple[torch.Tensor, LSTMState]:
    """Run an LSTM with torch semantics.

    Args:
      params: mapping of ``nn.LSTM`` names to tensors.
      x: (B, T, input_size).
      state: optional streaming carry; zeros of x's dtype if None.

    Returns:
      outputs (B, T, H*num_dirs) and the final LSTMState.
    """
    b = x.shape[0]
    hidden = params["weight_hh_l0"].shape[1]
    ndir = 2 if bidirectional else 1
    if state is None:
        zeros = x.new_zeros((ndir, b, hidden))
        state = LSTMState(zeros, zeros)
    if bidirectional:
        return _bidirectional(params, x, state.h, state.c)
    out, h_t, c_t = _forward(
        x, params["weight_ih_l0"], params["weight_hh_l0"],
        params["bias_ih_l0"], params["bias_hh_l0"], state.h[0], state.c[0])
    return out, LSTMState(h_t[None], c_t[None])


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
