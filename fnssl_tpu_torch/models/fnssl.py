"""FN-SSL: alternating full-band / narrow-band LSTM network (port of
``fnssl_tpu/models/fnssl.py``).

3 FN blocks, each a BiLSTM over *frequency* (full-band, nb·nt rows)
followed by an LSTM over *time* (narrow-band, nb·nf rows; one direction
when ``is_online``), with the reference's skip wiring:

  * fb_skip: the previous block's full-band LSTM output (pre-dropout) is
    added to the next block's full-band input.
  * nb_skip: block 1 concatenates the *raw block input* (time-major) to
    its narrow-band LSTM input (2·(H/2) + 4 = 260 wide at H = 256);
    blocks 2-3 add the previous narrow-band LSTM output (pre-dropout).

Head: 12× time average-pool → Linear(H→2) → tanh → (nb, nt/12, 2·nf)
[cos over nf ‖ sin over nf]; with ``is_doa`` → Linear(2·nf→180).

State-dict names equal the JAX parameter paths (block_1.fullLstm.
weight_ih_l0, …, emb2ipd.weight), so converted weights load strictly.
Streaming: the narrow-band LSTM states are the only cross-chunk state
(batch nb·nf, float32); the full-band BiLSTM always starts from zeros.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from fnssl_tpu_torch.models.layers import Linear, avg_pool_time, dropout
from fnssl_tpu_torch.models.lstm import LSTM, LSTMState
from fnssl_tpu_torch.utils.device import resolve_device

HIDDEN = 256
POOL = 12  # seg_fra_ratio: output frame rate = input/12


class FNSSLConfig(NamedTuple):
    input_size: int = 4
    hidden_size: int = HIDDEN
    is_online: bool = True
    is_doa: bool = False
    dropout: float = 0.2


class FNSSLState(NamedTuple):
    """Streaming carry: narrow-band LSTM state per block, batch = nb*nf."""
    narr: tuple[LSTMState, LSTMState, LSTMState]


def init_fnssl_state(nb: int, nf: int, cfg: FNSSLConfig = FNSSLConfig(),
                     device=None) -> FNSSLState:
    narr_h = cfg.hidden_size if cfg.is_online else cfg.hidden_size // 2
    ndir = 1 if cfg.is_online else 2
    z = torch.zeros((ndir, nb * nf, narr_h), device=device)
    return FNSSLState(narr=tuple(LSTMState(z, z) for _ in range(3)))


class FNBlock(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, is_first: bool,
                 is_online: bool, *, device, generator):
        super().__init__()
        full_h = hidden_size // 2
        narr_h = hidden_size if is_online else hidden_size // 2
        narr_in = 2 * full_h + (input_size if is_first else 0)
        self.is_first = is_first
        self.fullLstm = LSTM(input_size, full_h, bidirectional=True,
                             device=device, generator=generator)
        self.narrLstm = LSTM(narr_in, narr_h, bidirectional=not is_online,
                             device=device, generator=generator)

    def forward(self, x, fb_skip, nb_skip, narr_state, drop: float,
                generator=None):
        """x: (nb, nt, nf, nc) → (x, fb_out, nb_out, new narrow state)."""
        nb, nt, nf, nc = x.shape
        nb_skip_raw = x.permute(0, 2, 1, 3).reshape(nb * nf, nt, nc)

        x = x.reshape(nb * nt, nf, nc)
        if not self.is_first:
            x = x + fb_skip
        x, _ = self.fullLstm(x)
        fb_out = x
        x = dropout(x, drop, self.training, generator)

        x = x.reshape(nb, nt, nf, -1).permute(0, 2, 1, 3)
        x = x.reshape(nb * nf, nt, -1)
        if self.is_first:
            x = torch.cat([x, nb_skip_raw], dim=-1)
        else:
            x = x + nb_skip
        x, new_state = self.narrLstm(x, narr_state)
        nb_out = x
        x = dropout(x, drop, self.training, generator)

        x = x.reshape(nb, nf, nt, -1).permute(0, 2, 1, 3)  # (nb, nt, nf, h)
        return x, fb_out, nb_out, new_state


class FNSSL(nn.Module):
    """FN-SSL network. ``device=None`` is the first CUDA device; weights
    are U(-1/sqrt(fan), 1/sqrt(fan)) drawn from ``generator``."""

    def __init__(self, cfg: FNSSLConfig = FNSSLConfig(), *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        h = cfg.hidden_size
        kw = dict(is_online=cfg.is_online, device=device,
                  generator=generator)
        self.block_1 = FNBlock(cfg.input_size, h, True, **kw)
        self.block_2 = FNBlock(h, h, False, **kw)
        self.block_3 = FNBlock(h, h, False, **kw)
        self.emb2ipd = Linear(h, 2, device=device, generator=generator)
        if cfg.is_doa:
            self.ipd2doa = Linear(2 * h, 180, device=device,
                                  generator=generator)

    @property
    def device(self) -> torch.device:
        return self.emb2ipd.weight.device

    def forward(self, x: torch.Tensor, state: FNSSLState | None = None,
                return_state: bool = False,
                generator: torch.Generator | None = None):
        """Forward pass.

        Args:
          x: (nb, nc, nf, nt), the reference input layout.
          state: optional streaming carry; when given, x's time axis is a
            continuation chunk.
          generator: dropout randomness when training.

        Returns:
          (nb, nt/12, 2·nf) DP-IPD regression (or (nb, nt/12, 180) with
          is_doa), plus the new FNSSLState when ``return_state``.
        """
        x = x.permute(0, 3, 2, 1)                        # (nb, nt, nf, nc)
        nb, nt, nf, _ = x.shape
        if state is None:
            state = init_fnssl_state(nb, nf, self.cfg, x.device)
        fb = nbk = None
        new_narr = []
        for i, block in enumerate((self.block_1, self.block_2,
                                   self.block_3)):
            x, fb, nbk, ns = block(x, fb, nbk, state.narr[i],
                                   self.cfg.dropout, generator)
            new_narr.append(ns)

        x = x.permute(0, 2, 1, 3).reshape(nb * nf, nt, -1)
        ipd = torch.tanh(self.emb2ipd(avg_pool_time(x, POOL)))
        nt2 = ipd.shape[1]
        ipd = ipd.reshape(nb, nf, nt2, 2).permute(0, 2, 1, 3)
        result = torch.cat([ipd[..., 0], ipd[..., 1]], dim=2)
        if self.cfg.is_doa:
            result = self.ipd2doa(result)
        if return_state:
            return result, FNSSLState(narr=tuple(new_narr))
        return result
