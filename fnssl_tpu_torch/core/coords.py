"""Spherical/Cartesian coordinate transforms (port of
``fnssl_tpu/core/coords.py``; parity: FN-SSL/utils.py:56-81).

Convention: sph = (elevation theta in [0, pi] from +z, azimuth phi,
radius).
"""
from __future__ import annotations

import numpy as np
import torch


def cart2sph(cart: torch.Tensor, include_r: bool = False) -> torch.Tensor:
    """(..., 3) Cartesian → (..., 2) (theta, phi), or (..., 3) with r."""
    r = torch.sqrt(torch.sum(cart ** 2, dim=-1))
    theta = torch.arccos(cart[..., 2] / r)
    phi = torch.atan2(cart[..., 1], cart[..., 0])
    if include_r:
        return torch.stack((theta, phi, r), dim=-1)
    return torch.stack((theta, phi), dim=-1)


def cart2sph_np(cart):
    """Host-numpy variant in the reference Dataset convention
    (FN-SSL/Dataset.py:44-50): columns (r, elevation-from-+z, azimuth)."""
    xy2 = cart[..., 0] ** 2 + cart[..., 1] ** 2
    return np.stack([
        np.sqrt(xy2 + cart[..., 2] ** 2),
        np.arctan2(np.sqrt(xy2), cart[..., 2]),
        np.arctan2(cart[..., 1], cart[..., 0])], axis=-1)


def sph2cart(sph: torch.Tensor) -> torch.Tensor:
    """(..., 2) (theta, phi) on the unit sphere, or (..., 3) with r, →
    (..., 3) Cartesian."""
    if sph.shape[-1] == 2:
        sph = torch.cat([sph, torch.ones_like(sph[..., :1])], dim=-1)
    x = sph[..., 2] * torch.sin(sph[..., 0]) * torch.cos(sph[..., 1])
    y = sph[..., 2] * torch.sin(sph[..., 0]) * torch.sin(sph[..., 1])
    z = sph[..., 2] * torch.cos(sph[..., 0])
    return torch.stack((x, y, z), dim=-1)
