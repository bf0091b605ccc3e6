"""IPD → DOA decoding on the spatial-spectrum grid (port of
``fnssl_tpu/eval/decode.py``: ``idl_decode``, ``pd_decode``, IPDnet2's
``mse_decode`` and the frame-to-frame ``track_associate``).

The spatial spectrum is one batched matmul with divisor P·F/2; the
iterative detection & localization (IDL) decoder takes the argmax, the
least-squares scale of the best template against the residual IPD,
subtracts it and repeats, vectorized over (nb, nt). The peak-detection
(PD) decoder keeps the strict 8-neighbour maxima and takes the largest.
"""
from __future__ import annotations

import functools
import itertools
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


@functools.lru_cache(maxsize=None)
def _perm_indices(ns: int) -> tuple:
    return tuple(itertools.permutations(range(ns)))


def track_associate(doa: torch.Tensor) -> torch.Tensor:
    """Frame-to-frame track association by permutation argmin, the
    reference's dormant ``track_enable`` branch (FN-SSL/Module.py:623-644):
    a loop over frames, vectorized over the batch.

    ``doa``: (nb, nt, 2, ns) stacked (ele, azi). Frame t+1's tracks are
    reordered by the permutation minimizing the summed absolute difference
    to frame t's (already reordered) tracks; the azimuth row wraps via
    min(|d|, 2π−|d|). The VADs stay unpermuted, as in the reference
    (Module.py:622): callers permute only the DOAs.
    """
    nb, nt = doa.shape[:2]
    perms = torch.tensor(_perm_indices(doa.shape[-1]), device=doa.device)
    rows = torch.arange(nb, device=doa.device)
    prev = doa[:, 0]                                 # (nb, 2, ns)
    out = [prev]
    for t in range(1, nt):
        cand = doa[:, t][:, :, perms]                # (nb, 2, n_perm, ns)
        d1 = (cand - prev[:, :, None, :]).abs()
        d2 = torch.cat([d1[:, :1], 2 * np.pi - d1[:, 1:]], dim=1)
        cost = torch.minimum(d1, d2)
        # summed element by element, row-major over (ele/azi, track): the
        # order XLA sums in, so that exact ties break as in JAX
        total = cost[:, 0, :, 0]
        for i, k in itertools.product(range(2), range(cost.shape[-1])):
            if i or k:
                total = total + cost[:, i, :, k]
        best = total.argmin(dim=-1)
        prev = cand[rows, :, best, :]
        out.append(prev)
    return torch.stack(out, dim=1)


def idl_decode(pred_ipd: torch.Tensor, template: torch.Tensor,
               ele_candidate: torch.Tensor, azi_candidate: torch.Tensor,
               max_num_sources: int = 1,
               source_num_mode: str = "unkNum",
               track: bool = False) -> DecodeResult:
    """Iterative detection & localization. VAD = LS ratio ('unkNum') or
    1 ('kNum'). ``track=True`` reassociates tracks frame to frame
    (``track_associate``)."""
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
    doa = torch.stack(doas, dim=-1)                    # (nb, nt, 2, ns)
    if track:
        doa = track_associate(doa)
    return DecodeResult(doa, torch.stack(vads, dim=-1), first_ss)


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
    (what the JAX package's ``top_k`` over -inf gives). ``track=True``
    reassociates tracks frame to frame.
    """
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
    if track:
        doa = track_associate(doa)
    vad = torch.ones_like(vals) if source_num_mode == "kNum" else vals
    return DecodeResult(doa, vad, ss_full)


def mse_decode(pred_ipd: torch.Tensor, template: torch.Tensor,
               ele_candidate: torch.Tensor, azi_candidate: torch.Tensor,
               max_num_sources: int = 1,
               source_num_mode: str = "unkNum") -> DecodeResult:
    """IPDnet2's decode variant (IPDnet2/Module.py:596-655): the spatial
    spectrum is the per-grid-point MSE between prediction and template
    (argmin instead of argmax), the detection score is that minimum MSE
    (smaller = more confident), and iterative source removal subtracts
    the best template unscaled."""
    nb, nt, f, p = pred_ipd.shape
    nele, nazi = template.shape[:2]
    flat_t = template.reshape(nele * nazi, f * p)
    residual = pred_ipd.reshape(nb, nt, f * p)
    first_ss = None
    doas, vads = [], []
    for _ in range(max_num_sources):
        diff = residual[:, :, None, :] - flat_t[None, None, :, :]
        ss = (diff * diff).mean(dim=-1)                # (nb, nt, G)
        if first_ss is None:
            first_ss = ss.reshape(nb, nt, nele, nazi)
        idx = torch.argmin(ss, dim=-1)
        ele_i, azi_i = idx // nazi, idx % nazi
        doas.append(torch.stack([ele_candidate[ele_i],
                                 azi_candidate[azi_i]], dim=-1))
        best = flat_t[idx]
        mse = ((best - residual) ** 2).mean(dim=-1)
        residual = residual - best
        vads.append(torch.ones_like(mse) if source_num_mode == "kNum"
                    else mse)
    return DecodeResult(torch.stack(doas, dim=-1), torch.stack(vads, dim=-1),
                        first_ss)


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
