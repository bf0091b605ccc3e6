"""Direct-path inter-channel phase difference (DP-IPD) template grid
(port of the template half of ``fnssl_tpu/physics/dpipd.py: DPIPD``;
the per-frame training targets are not ported yet).

Sign convention, the reference's single effective one:

    IPD(f, doa) = exp(-1j * 2*pi * f * r(doa)·(loc[m2]-loc[m1]) / c)

The template is built once per (grid, array) in float64 numpy and stored
as complex64, like the reference's numpy computation.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from fnssl_tpu_torch.core.pairs import pair_indices


def _doa_unit_vectors(ele, azi):
    """r(ele, azi): unit vector, ele from +z, azi in xy-plane. (...,3)."""
    x = np.sin(ele) * np.cos(azi)
    return np.stack([x,
                     np.sin(ele) * np.sin(azi),
                     np.broadcast_to(np.cos(ele), x.shape)], axis=-1)


class DPIPD:
    """Far-field DP-IPD template grid.

    Args: ndoa_candidate=(nele, nazi), mic_location (nmic, 3), nf,
    fre_max, ch_mode, speed (343 here; PredDOA passes 340).
    """

    def __init__(self, ndoa_candidate: Sequence[int],
                 mic_location: np.ndarray, nf: int = 257,
                 fre_max: float = 8000.0, ch_mode: str = "M",
                 speed: float = 343.0,
                 ele_range: tuple[float, float] = (0.0, np.pi),
                 azi_range: tuple[float, float] = (-np.pi, np.pi)):
        self.mic_location = np.asarray(mic_location, np.float64)
        self.nf = nf
        self.fre_max = float(fre_max)
        self.speed = float(speed)
        self.ch_mode = ch_mode
        nmic = self.mic_location.shape[-2]
        self.first, self.second = pair_indices(nmic, ch_mode)

        nele, nazi = ndoa_candidate
        ele = np.linspace(ele_range[0], ele_range[1], nele)
        azi = np.linspace(azi_range[0], azi_range[1], nazi)
        r = _doa_unit_vectors(ele[:, None], azi[None, :])  # (nele,nazi,3)
        baseline = (self.mic_location[self.second]
                    - self.mic_location[self.first])       # (P, 3)
        itd = np.einsum("ead,pd->eap", r, baseline) / self.speed
        fre = np.linspace(0.0, self.fre_max, nf)
        ipd = -2.0 * np.pi * fre[None, None, :, None] * itd[:, :, None, :]
        # (nele, nazi, nf, P) complex64, the reference template layout
        self.template = np.exp(1j * ipd).astype(np.complex64)
        self.doa_candidate = [ele, azi]
