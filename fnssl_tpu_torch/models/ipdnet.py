"""IPDnet: multi-track DP-IPD estimation, fixed and variable arrays (port
of ``fnssl_tpu/models/ipdnet.py``).

  * ``IPDnet`` (IPDnet/FixedAarryIPDnet.py:7-120): 2 FN blocks whose LSTM
    outputs are each concatenated with the *raw input* skip, then a
    causal CNN head (3 causal 3×3 convs, ReLU, time pools of 3 and 4 →
    12× compression, tanh) producing (nb, nt/12, 2nf, nmic-1, max_track)
    multi-track IPD. The output reshapes copy the reference's
    permute/reshape chain, so converted checkpoints mean the same.
    ``offline_inference`` (the offline model) folds 312-frame segments
    into the batch and stitches them back.
  * ``VariableIPDnet`` (IPDnet/VariableArrayIPDnet.py:6-118): mic pairs
    ride the batch axis in nb-major groups; each block concatenates the
    mean embedding over the utterance's own pairs and the raw skip and
    projects through Linear+PReLU around the narrow-band LSTM, with the
    intended wiring (narrLstm input = hidden), as the JAX package.

State-dict names equal the JAX parameter paths (block_1.fullLstm.
weight_ih_l0, conv.conv1.weight, block_1.linear1.bias, ...), so converted
weights load strictly. Every LSTM runs ``models.lstm.LSTM`` (K1 forward,
K2 backward); the convs are ``F.conv2d``, as the JAX package leaves them
to XLA.

Streaming: the narrow-band LSTM states and the head's three causal-conv
tails (the last 2 frames at the frame rate, /3 and /12) are carried in
``IPDnetState``; chunks of a multiple of 12 frames give the one-shot
output.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from fnssl_tpu_torch.models.layers import (Conv2d, Linear, PReLU,
                                           dropout)
from fnssl_tpu_torch.models.lstm import LSTM, LSTMState
from fnssl_tpu_torch.utils.device import resolve_device

POOL = 12
CONV_CH = 128                  # the head's hidden channels


class IPDnetConfig(NamedTuple):
    input_size: int = 4          # 2·nmic (re+im per mic)
    hidden_size: int = 128
    max_track: int = 2
    is_online: bool = True
    dropout: float = 0.2
    n_seg: int = 312             # offline chunked-inference segment length


class ConvState(NamedTuple):
    """Causal-conv tails: the last 2 frames at each head rate."""
    c1: torch.Tensor  # (nb, cin, nf, 2) at the frame rate
    c2: torch.Tensor  # (nb, 128, nf, 2) at rate/3
    c3: torch.Tensor  # (nb, 128, nf, 2) at rate/12


class IPDnetState(NamedTuple):
    narr: tuple[LSTMState, ...]
    conv: ConvState


def init_ipdnet_state(nb: int, nf: int, cfg: IPDnetConfig = IPDnetConfig(),
                      device=None) -> IPDnetState:
    h = cfg.hidden_size
    narr_h = h if cfg.is_online else h // 2
    ndir = 1 if cfg.is_online else 2
    z = torch.zeros((ndir, nb * nf, narr_h), device=device)
    return IPDnetState(
        narr=(LSTMState(z, z), LSTMState(z, z)),
        conv=ConvState(
            torch.zeros((nb, h + cfg.input_size, nf, 2), device=device),
            torch.zeros((nb, CONV_CH, nf, 2), device=device),
            torch.zeros((nb, CONV_CH, nf, 2), device=device)))


class IPDnetBlock(nn.Module):
    """FN block of IPDnet (FixedAarryIPDnet.py:29-41): a BiLSTM over
    frequency, then an LSTM over time (both directions when offline),
    each followed by a concat of the raw input."""

    def __init__(self, in_size: int, cfg: IPDnetConfig, *, device,
                 generator):
        super().__init__()
        full_h = cfg.hidden_size // 2
        narr_h = cfg.hidden_size if cfg.is_online else cfg.hidden_size // 2
        self.fullLstm = LSTM(in_size, full_h, bidirectional=True,
                             device=device, generator=generator)
        self.narrLstm = LSTM(2 * full_h + cfg.input_size, narr_h,
                             bidirectional=not cfg.is_online, device=device,
                             generator=generator)

    def forward(self, x, fb_skip, nb_skip, narr_state, drop: float,
                generator=None):
        """x (nb, nt, nf, nc) → ((nb, nt, nf, narr_out + input), state)."""
        nb, nt, nf, nc = x.shape
        x, _ = self.fullLstm(x.reshape(nb * nt, nf, nc))
        x = dropout(x, drop, self.training, generator)
        x = torch.cat([x, fb_skip], dim=-1)
        x = x.reshape(nb, nt, nf, -1).permute(0, 2, 1, 3)
        x, new_state = self.narrLstm(x.reshape(nb * nf, nt, -1), narr_state)
        x = dropout(x, drop, self.training, generator)
        x = torch.cat([x, nb_skip], dim=-1)
        return x.reshape(nb, nf, nt, -1).permute(0, 2, 1, 3), new_state


def _pool_t(x: torch.Tensor, k: int) -> torch.Tensor:
    """Mean over non-overlapping windows of k frames on the last axis;
    the last nt % k frames are dropped."""
    nb, c, nf, nt = x.shape
    return x[..., : nt // k * k].reshape(nb, c, nf, nt // k, k).mean(-1)


class CausCNN(nn.Module):
    """The causal CNN head (FixedAarryIPDnet.py:43-73). The reference pads
    time by 2 on both sides and crops 2 on the right: a left pad of 2.
    Streaming puts the carried tail in place of the zero pad."""

    def __init__(self, cin: int, cout: int, *, device, generator):
        super().__init__()
        kw = dict(bias=False, padding=((1, 1), (0, 0)), device=device,
                  generator=generator)
        self.conv1 = Conv2d(cin, CONV_CH, (3, 3), **kw)
        self.conv2 = Conv2d(CONV_CH, CONV_CH, (3, 3), **kw)
        self.conv3 = Conv2d(CONV_CH, cout, (3, 3), **kw)

    @staticmethod
    def _causal(conv, x, tail):
        if tail is None:
            x_in = nn.functional.pad(x, (2, 0))
        else:
            x_in = torch.cat([tail.to(x.dtype), x], dim=-1)
        return conv(x_in), x_in[..., -2:]

    def forward(self, x: torch.Tensor, state: ConvState | None = None):
        """x (nb, c, nf, nt) → ((nb, cout, nf, nt/12), new ConvState)."""
        tails = (None,) * 3 if state is None else state
        out, n1 = self._causal(self.conv1, x, tails[0])
        out = _pool_t(torch.relu(out), 3)
        out, n2 = self._causal(self.conv2, out, tails[1])
        out = _pool_t(torch.relu(out), 4)
        out, n3 = self._causal(self.conv3, out, tails[2])
        return torch.tanh(out), ConvState(n1, n2, n3)


class IPDnet(nn.Module):
    """Fixed-array IPDnet (online, or offline with ``is_online=False``).
    ``device=None`` is the first CUDA device; weights are torch's default
    inits drawn from ``generator``."""

    def __init__(self, cfg: IPDnetConfig = IPDnetConfig(), *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        h, i = cfg.hidden_size, cfg.input_size
        kw = dict(device=device, generator=generator)
        self.block_1 = IPDnetBlock(i, cfg, **kw)
        self.block_2 = IPDnetBlock(h + i, cfg, **kw)
        self.conv = CausCNN(h + i, 2 * (i // 2 - 1) * cfg.max_track, **kw)

    @property
    def device(self) -> torch.device:
        return self.conv.conv1.weight.device

    def forward(self, x: torch.Tensor, state: IPDnetState | None = None,
                return_state: bool = False,
                generator: torch.Generator | None = None,
                offline_inference: bool = False):
        """Forward pass.

        Args:
          x: (nb, nc, nf, nt), the reference input layout.
          state: optional streaming carry; x's time axis then continues
            the previous chunk.
          generator: dropout randomness when training.
          offline_inference: for the offline model, run ``cfg.n_seg``-frame
            segments batched through the net and stitch them back
            (FixedAarryIPDnet.py:97-117).

        Returns:
          (nb, nt/12, 2nf, nmic-1, max_track), plus the new IPDnetState
          when ``return_state``.
        """
        cfg = self.cfg
        nb0, nc0, nf0, nt0 = x.shape
        ou_frame = nt0 // POOL
        chunked = offline_inference and not cfg.is_online
        nseg = 1
        if chunked:
            seg = cfg.n_seg
            x = nn.functional.pad(x, (0, (-nt0) % seg))
            nseg = x.shape[-1] // seg
            x = x.reshape(nb0, nc0, nf0, nseg, seg).permute(0, 3, 1, 2, 4)
            x = x.reshape(nb0 * nseg, nc0, nf0, seg)

        x = x.permute(0, 3, 2, 1)                    # (nb, nt, nf, nc)
        nb, nt, nf, nc = x.shape
        st = (init_ipdnet_state(nb, nf, cfg, x.device) if state is None
              else state)
        fb_skip = x.reshape(nb * nt, nf, nc)
        nb_skip = x.permute(0, 2, 1, 3).reshape(nb * nf, nt, nc)
        new_narr = []
        for i, block in enumerate((self.block_1, self.block_2)):
            x, ns = block(x, fb_skip, nb_skip, st.narr[i], cfg.dropout,
                          generator)
            new_narr.append(ns)

        x = x.permute(0, 3, 2, 1)                    # (nb, c, nf, nt)
        nt2 = nt // POOL
        x, new_conv = self.conv(x, st.conv if state is not None else None)

        # the reference's output reshape chain (FixedAarryIPDnet.py:111-117)
        x = x.permute(0, 3, 2, 1)                    # (nb, nt2, nf, out)
        x = x.reshape(nb, nt2, nf, 2, -1).permute(0, 1, 3, 2, 4)
        if chunked:
            x = x.reshape(nb // nseg, nt2 * nseg, 2, nf * 2, -1)
            out = x.permute(0, 1, 3, 4, 2)[:, :ou_frame]
        else:
            x = x.reshape(nb, nt2, 2, nf * 2, -1)
            out = x.permute(0, 1, 3, 4, 2)
        if return_state:
            return out, IPDnetState(tuple(new_narr), new_conv)
        return out


# ---------------------------------------------------------------------------
# Variable-array IPDnet


class VariableIPDnetConfig(NamedTuple):
    input_size: int = 4
    hidden_size: int = 128
    is_online: bool = True
    dropout: float = 0.2


def _pair_mean(x: torch.Tensor, npair: int) -> torch.Tensor:
    """Mean over each utterance's own pair group, broadcast back. The
    batch axis is nb-major pairs (row b·P+p), so utterances never mix."""
    g = x.reshape((x.shape[0] // npair, npair) + x.shape[1:])
    return g.mean(dim=1, keepdim=True).expand(g.shape).reshape(x.shape)


class VariableIPDnetBlock(nn.Module):
    """Pair-mean FN block (VariableArrayIPDnet.py:33-55)."""

    def __init__(self, in_size: int, cfg: VariableIPDnetConfig, *, device,
                 generator):
        super().__init__()
        h, i = cfg.hidden_size, cfg.input_size
        narr_h = h if cfg.is_online else h // 2
        ndir = 1 if cfg.is_online else 2
        kw = dict(device=device, generator=generator)
        self.fullLstm = LSTM(in_size, h // 2, bidirectional=True, **kw)
        self.narrLstm = LSTM(h, narr_h, bidirectional=not cfg.is_online,
                             **kw)
        self.linear1 = Linear(2 * h + i, h, **kw)
        self.linear2 = Linear(narr_h * ndir * 2 + i, h, **kw)
        self.relu1 = PReLU(device=device)
        self.relu2 = PReLU(device=device)

    def forward(self, x, skip, npair: int, drop: float, generator=None):
        """x (nbp, nt, nf, nc), batch nb·npair → (nbp, nt, nf, hidden)."""
        nbp, nt, nf, nc = x.shape
        x, _ = self.fullLstm(x.reshape(nbp * nt, nf, nc))
        x = dropout(x, drop, self.training, generator)
        x = x.reshape(nbp, nt, nf, -1)
        x = torch.cat([x, _pair_mean(x, npair), skip], dim=-1)
        x = x.permute(0, 2, 1, 3).reshape(nbp * nf, nt, -1)
        x, _ = self.narrLstm(self.relu1(self.linear1(x)))
        x = dropout(x, drop, self.training, generator)
        x = x.reshape(nbp, nf, nt, -1).permute(0, 2, 1, 3)
        x = torch.cat([x, _pair_mean(x, npair), skip], dim=-1)
        return self.relu2(self.linear2(x))


class VariableIPDnet(nn.Module):
    """Variable-array IPDnet: any mic count, pairs on the batch axis."""

    def __init__(self, cfg: VariableIPDnetConfig = VariableIPDnetConfig(),
                 *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        h, i = cfg.hidden_size, cfg.input_size
        kw = dict(device=device, generator=generator)
        self.block_1 = VariableIPDnetBlock(i, cfg, **kw)
        self.block_2 = VariableIPDnetBlock(h, cfg, **kw)
        self.conv = CausCNN(h, 4, **kw)

    @property
    def device(self) -> torch.device:
        return self.conv.conv1.weight.device

    def forward(self, x: torch.Tensor, npair: int | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: (nb·npair, 4, nf, nt), mic pairs on the batch axis in
        nb-major order. ``npair`` is the pairs an utterance has; None
        means one utterance (the reference's bz=1 convention). Returns
        (nb, nt/12, 2nf, npair, 2 tracks)."""
        if npair is None:
            npair = x.shape[0]
        x = x.permute(0, 3, 2, 1)                    # (nbp, nt, nf, nc)
        nbp, nt, nf, _ = x.shape
        nb = nbp // npair
        skip = x
        for block in (self.block_1, self.block_2):
            x = block(x, skip, npair, self.cfg.dropout, generator)
        x, _ = self.conv(x.permute(0, 3, 2, 1))
        nt2 = nt // POOL
        x = x.permute(0, 3, 2, 1).reshape(nbp, nt2, nf, 2, -1)
        x = x.permute(0, 1, 3, 2, 4).reshape(nb, npair, nt2, -1, nf * 2)
        return x.permute(0, 2, 4, 1, 3)
