"""Chunked offline-inference reshapes (port of
``fnssl_tpu/data/segments.py``; parity: IPDnet/utils_.py:152-167)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_segments(x: torch.Tensor, seg_len: int):
    """Pad the time axis (last dim = nt) to a multiple of seg_len.
    Returns (padded x, the original nt)."""
    nt = x.shape[-1]
    rem = (-nt) % seg_len
    if rem == 0:
        return x, nt
    return F.pad(x, (0, rem)), nt


def split_segments(x: torch.Tensor, seg_len: int):
    """(nb, nc, nf, nt) → (nb·nseg, nc, nf, seg_len): batch the chunks."""
    x, orig_nt = pad_segments(x, seg_len)
    nb, nc, nf, nt = x.shape
    nseg = nt // seg_len
    x = x.reshape(nb, nc, nf, nseg, seg_len).permute(0, 3, 1, 2, 4)
    return x.reshape(nb * nseg, nc, nf, seg_len), orig_nt


def merge_segments(y: torch.Tensor, nb: int, orig_nt2: int) -> torch.Tensor:
    """Inverse stitch along the output frame axis: (nb·nseg, nt2, ...) →
    (nb, nseg·nt2, ...) cropped to the un-padded length."""
    nseg = y.shape[0] // nb
    y = y.reshape((nb, nseg) + tuple(y.shape[1:]))
    y = y.reshape((nb, nseg * y.shape[2]) + tuple(y.shape[3:]))
    return y[:, :orig_nt2]
