"""Direct-path inter-channel phase difference (DP-IPD): the template grid
and the per-frame training targets (port of ``fnssl_tpu/physics/dpipd.py``:
the far-field ``DPIPD`` and IPDnet2's near-field ``DPIPD2``).

Sign convention, the reference's single effective one, shared by the
template and the targets:

    IPD(f, doa) = exp(-1j * 2*pi * f * r(doa)·(loc[m2]-loc[m1]) / c)

``DPIPD2``'s targets use the opposite sign on exact path lengths, as the
reference does (see its docstring). The template is built once per
(grid, array) in float64 numpy and stored
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


class DPIPD2:
    """Near-field DP-IPD: exact per-mic distances at (doa, distance).

    Parity: IPDnet2/Module.py:413-498. Per-frame targets use true
    propagation-path length differences: IPD = +2πf·(d2-d1)/c (the
    reference's double-negated convention at Module.py:471-474, consistent
    with the far-field template in the far-field limit). The *template*
    grid remains far-field with elevation pinned to π/2 (Module.py:
    427-439), as in the reference. The targets take the array topology as
    data (per batch), so one target function serves every topology.
    """

    def __init__(self, ndoa_candidate: Sequence[int],
                 mic_location: np.ndarray, nf: int = 257,
                 fre_max: float = 8000.0, ch_mode: str = "M",
                 speed: float = 343.0,
                 ele_range: tuple[float, float] = (np.pi / 2, np.pi / 2),
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
                    - self.mic_location[self.first])
        itd = np.einsum("ead,pd->eap", r, baseline) / self.speed
        fre = np.linspace(0.0, self.fre_max, nf)
        ipd = -2.0 * np.pi * fre[None, None, :, None] * itd[:, :, None, :]
        self.template = np.exp(1j * ipd).astype(np.complex64)
        self.doa_candidate = [ele, azi]
        self._fre = fre.astype(np.float32)
        self._tables: dict[torch.device, torch.Tensor] = {}

    def _fre_on(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = torch.as_tensor(self._fre, device=device)
        return self._tables[device]

    def targets(self, source_doa: torch.Tensor, distance: torch.Tensor,
                mic_location: torch.Tensor | None = None) -> torch.Tensor:
        """Near-field per-frame targets.

        Args:
          source_doa: (nb, nt, 2, ns) (ele, azi) radians.
          distance: (nb, nt, ns) source range in meters.
          mic_location: optional per-batch (nb, nmic, 3) topology; defaults
            to the constructor's topology.
        Returns:
          (nb, nt, nf, P, ns) complex64.
        """
        device = source_doa.device
        if mic_location is None:
            mic = torch.as_tensor(self.mic_location.astype(np.float32),
                                  device=device)[None].expand(
                source_doa.shape[0], -1, -1)
        else:
            mic = mic_location.to(device=device, dtype=torch.float32)
        fre = self._fre_on(device)
        ele, azi = source_doa[:, :, 0, :], source_doa[:, :, 1, :]
        r = torch.stack([torch.sin(ele) * torch.cos(azi),
                         torch.sin(ele) * torch.sin(azi),
                         torch.cos(ele)], dim=-1)        # (nb, nt, ns, 3)
        src = r * distance[..., None]
        # distances to each mic: (nb, nt, ns, nmic)
        d = torch.linalg.vector_norm(src[:, :, :, None, :]
                                     - mic[:, None, None, :, :], dim=-1)
        first = torch.as_tensor(self.first, dtype=torch.long,
                                device=device)
        second = torch.as_tensor(self.second, dtype=torch.long,
                                 device=device)
        itd = (d.index_select(-1, second) - d.index_select(-1, first)) \
            / self.speed                                 # (nb, nt, ns, P)
        # reference sign: IPD = -2πf·ITD·(-1) = +2πf·(d2-d1)/c
        ipd = (2.0 * np.pi) * fre[None, None, None, :, None] \
            * itd[:, :, :, None, :]
        out = torch.complex(torch.cos(ipd), torch.sin(ipd))
        return out.permute(0, 1, 3, 4, 2)
