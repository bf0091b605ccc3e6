"""IPD → DOA decoding on the spatial-spectrum grid (port of the IDL half
of ``fnssl_tpu/eval/decode.py``; ``pd_decode``, ``mse_decode`` and
``track_associate`` are not ported yet).

The spatial spectrum is one batched matmul with divisor P·F/2; the
iterative detection & localization (IDL) decoder takes the argmax, the
least-squares scale of the best template against the residual IPD,
subtracts it and repeats, vectorized over (nb, nt).
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
               source_num_mode: str = "unkNum") -> DecodeResult:
    """Iterative detection & localization. VAD = LS ratio ('unkNum') or
    1 ('kNum')."""
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
