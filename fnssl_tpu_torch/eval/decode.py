"""IPD → DOA decoding on the spatial-spectrum grid (port of
``fnssl_tpu/eval/decode.py``: ``idl_decode`` and ``pd_decode``;
``mse_decode`` and ``track_associate`` wait for the IPDnet port, and
``track=True`` raises until then — FN-SSL's decode never asks for it).

The spatial spectrum is one batched matmul with divisor P·F/2; the
iterative detection & localization (IDL) decoder takes the argmax, the
least-squares scale of the best template against the residual IPD,
subtracts it and repeats, vectorized over (nb, nt). The peak-detection
(PD) decoder keeps the strict 8-neighbour maxima and takes the largest.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DecodeResult(NamedTuple):
    doa: torch.Tensor               # (nb, nt, 2, ns) radians (ele, azi)
    vad: torch.Tensor               # (nb, nt, ns) detection score
    spatial_spectrum: torch.Tensor  # (nb, nt, nele, nazi)


def spatial_spectrum(pred_ipd: torch.Tensor, template: torch.Tensor
                     ) -> torch.Tensor:
    """(nb, nt, F, P) × (nele, nazi, F, P) → (nb, nt, nele, nazi)."""
    nb, nt, f, p = pred_ipd.shape
    nele, nazi = template.shape[:2]
    flat_t = template.reshape(nele * nazi, f * p)
    ss = pred_ipd.reshape(nb, nt, f * p) @ flat_t.T / (p * f / 2)
    return ss.reshape(nb, nt, nele, nazi)


def idl_decode(pred_ipd: torch.Tensor, template: torch.Tensor,
               ele_candidate: torch.Tensor, azi_candidate: torch.Tensor,
               max_num_sources: int = 1,
               source_num_mode: str = "unkNum",
               track: bool = False) -> DecodeResult:
    """Iterative detection & localization. VAD = LS ratio ('unkNum') or
    1 ('kNum')."""
    _no_tracking(track)
    nb, nt, f, p = pred_ipd.shape
    nele, nazi = template.shape[:2]
    flat_t = template.reshape(nele * nazi, f * p)
    residual = pred_ipd.reshape(nb, nt, f * p)
    first_ss = None
    doas, vads = [], []
    for _ in range(max_num_sources):
        ss = residual @ flat_t.T / (p * f / 2)         # (nb, nt, G)
        if first_ss is None:
            first_ss = ss.reshape(nb, nt, nele, nazi)
        idx = torch.argmax(ss, dim=-1)                 # (nb, nt)
        ele_i, azi_i = idx // nazi, idx % nazi
        doas.append(torch.stack([ele_candidate[ele_i],
                                 azi_candidate[azi_i]], dim=-1))
        best = flat_t[idx]                             # (nb, nt, F·P)
        ratio = ((best * residual).sum(-1)
                 / (best * best).sum(-1))              # (nb, nt)
        residual = residual - ratio[..., None] * best
        vads.append(torch.ones_like(ratio) if source_num_mode == "kNum"
                    else ratio)
    return DecodeResult(torch.stack(doas, dim=-1), torch.stack(vads, dim=-1),
                        first_ss)


def _no_tracking(track: bool) -> None:
    if track:
        raise NotImplementedError("track=True (track_associate) is not "
                                  "ported yet")


def pd_decode(pred_ipd: torch.Tensor, template: torch.Tensor,
              ele_candidate: torch.Tensor, azi_candidate: torch.Tensor,
              max_num_sources: int = 2, source_num_mode: str = "unkNum",
              track: bool = False) -> DecodeResult:
    """Peak detection: strict 8-neighbour maxima on the (ele, azi) grid,
    circular in azimuth (last redundant column dropped), replicated at
    the elevation borders; top-k peaks by value, lower grid index first
    on a tie (``jax.lax.top_k``'s order).

    When fewer than ``max_num_sources`` peaks exist, the remaining slots
    take non-peak cells in grid order, their raw values as VAD scores
    (what the JAX package's ``top_k`` over -inf gives).
    """
    _no_tracking(track)
    ss_full = spatial_spectrum(pred_ipd, template)   # (nb, nt, nele, nazi)
    ss = ss_full[..., :-1]                           # drop redundant azi

    up = torch.cat([ss[:, :, :1], ss[:, :, :-1]], dim=2)
    down = torch.cat([ss[:, :, 1:], ss[:, :, -1:]], dim=2)

    def wrap(a):  # circular azimuth neighbours
        return (torch.cat([a[..., -1:], a[..., :-1]], dim=-1),
                torch.cat([a[..., 1:], a[..., :1]], dim=-1))

    left, right = wrap(ss)
    ul, ur = wrap(up)
    dl, dr = wrap(down)
    peaks = ((ss > up) & (ss > down) & (ss > left) & (ss > right)
             & (ss > ul) & (ss > ur) & (ss > dl) & (ss > dr))

    nb, nt, nele, nazi_c = ss.shape
    masked = torch.where(peaks, ss, torch.full_like(ss, -torch.inf))
    masked = masked.reshape(nb, nt, -1)
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :max_num_sources], idx[..., :max_num_sources]
    # fall back to raw values for non-peak slots
    raw = ss.reshape(nb, nt, -1)
    vals = torch.where(torch.isfinite(vals), vals,
                       torch.gather(raw, -1, idx))
    ele_i, azi_i = idx // nazi_c, idx % nazi_c
    doa = torch.stack([ele_candidate[ele_i], azi_candidate[azi_i]],
                      dim=2)                         # (nb, nt, 2, ns)
    vad = torch.ones_like(vals) if source_num_mode == "kNum" else vals
    return DecodeResult(doa, vad, ss_full)


def time_pool_ipd(pred_ipd: torch.Tensor, pool: int) -> torch.Tensor:
    """(nb, nt, F, P) → (nb, nt//pool, F, P) mean pooling."""
    nb, nt, f, p = pred_ipd.shape
    t2 = nt // pool
    return pred_ipd[:, : t2 * pool].reshape(nb, t2, pool, f, p).mean(dim=2)


def template_ri(template: np.ndarray, fre_used) -> np.ndarray:
    """Complex (nele, nazi, nf, P) template → real/imag concat over the
    used bins, the decode-side layout."""
    sel = template[:, :, fre_used]
    return np.concatenate([sel.real, sel.imag], axis=2).astype(np.float32)
