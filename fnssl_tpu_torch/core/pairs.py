"""Microphone-pair feature assembly (port of ``fnssl_tpu/core/pairs.py``).

Pair orderings match the reference exactly:
  'M'  : (0,1), (0,2), ..., (0,nch-1)                     → P = nch-1
  'MM' : (0,1)..(0,n-1), (1,2)..(1,n-1), ..., (n-2,n-1)   → P = nch(nch-1)/2
"""
from __future__ import annotations

import numpy as np
import torch


def pair_indices(nch: int, ch_mode: str) -> tuple[np.ndarray, np.ndarray]:
    """First/second mic index per pair, in reference order."""
    if ch_mode == "M":
        first = np.zeros(nch - 1, np.int32)
        second = np.arange(1, nch, dtype=np.int32)
    elif ch_mode == "MM":
        first = np.array([i for i in range(nch - 1)
                          for _ in range(i + 1, nch)], np.int32)
        second = np.array([j for i in range(nch - 1)
                           for j in range(i + 1, nch)], np.int32)
    else:
        raise ValueError(f"unknown ch_mode {ch_mode!r}")
    return first, second


def num_pairs(nch: int, ch_mode: str) -> int:
    return nch - 1 if ch_mode == "M" else nch * (nch - 1) // 2


def pair_rebatch(data: torch.Tensor, ch_mode: str = "M") -> torch.Tensor:
    """(nb, nch, ...) → (nb*P, 2, ...) with the pair dim folded into batch:
    out[b*P+p, 0] = data[b, first[p]], out[b*P+p, 1] = data[b, second[p]].
    """
    nb, nch = data.shape[:2]
    first, second = pair_indices(nch, ch_mode)
    first = torch.as_tensor(first, dtype=torch.long, device=data.device)
    second = torch.as_tensor(second, dtype=torch.long, device=data.device)
    out = torch.stack([data[:, first], data[:, second]], dim=2)
    return out.reshape((nb * len(first), 2) + tuple(data.shape[2:]))


def pair_unbatch(data: torch.Tensor, nb: int) -> torch.Tensor:
    """(nb*P, ...) → (nb, P, ...): inverse of the batch fold."""
    p = data.shape[0] // nb
    return data.reshape((nb, p) + tuple(data.shape[1:]))
