"""Direct-path inter-channel phase difference (DP-IPD): the template grid
and the per-frame training targets (port of ``fnssl_tpu/physics/dpipd.py:
DPIPD``).

Sign convention, the reference's single effective one, shared by the
template and the targets:

    IPD(f, doa) = exp(-1j * 2*pi * f * r(doa)·(loc[m2]-loc[m1]) / c)

The template is built once per (grid, array) in float64 numpy and stored
as complex64, like the reference's numpy computation. The targets are
torch ops on the DOAs' device; their baseline and frequency tables are
made there once (float32, as the JAX package's).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from fnssl_tpu_torch.core.pairs import pair_indices


def _doa_unit_vectors(ele, azi):
    """r(ele, azi): unit vector, ele from +z, azi in xy-plane. (...,3)."""
    x = np.sin(ele) * np.cos(azi)
    return np.stack([x,
                     np.sin(ele) * np.sin(azi),
                     np.broadcast_to(np.cos(ele), x.shape)], axis=-1)


class DPIPD:
    """Far-field DP-IPD template grid and per-frame target generator.

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
        self._baseline = baseline.astype(np.float32)
        self._fre = fre.astype(np.float32)
        self._tables: dict[torch.device, tuple[torch.Tensor,
                                               torch.Tensor]] = {}

    def tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(baseline (P, 3), frequencies (nf,)) float32 on ``device``,
        made at the first use there."""
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = (
                torch.as_tensor(self._baseline, device=device),
                torch.as_tensor(self._fre, device=device))
        return self._tables[device]

    def targets(self, source_doa: torch.Tensor) -> torch.Tensor:
        """Per-frame DP-IPD targets.

        Args:
          source_doa: (nb, nt, 2, ns) float32, (ele, azi) radians per
            frame per source.
        Returns:
          (nb, nt, nf, P, ns) complex64, the reference output layout.
        """
        baseline, fre = self.tables(source_doa.device)
        ele, azi = source_doa[:, :, 0, :], source_doa[:, :, 1, :]
        r = torch.stack([torch.sin(ele) * torch.cos(azi),
                         torch.sin(ele) * torch.sin(azi),
                         torch.cos(ele)], dim=-1)        # (nb, nt, ns, 3)
        itd = torch.einsum("btsd,pd->btsp", r, baseline) / self.speed
        ipd = (-2.0 * np.pi) * fre[None, None, None, :, None] \
            * itd[:, :, :, None, :]                      # (nb, nt, ns, nf, P)
        out = torch.complex(torch.cos(ipd), torch.sin(ipd))
        return out.permute(0, 1, 3, 4, 2)
