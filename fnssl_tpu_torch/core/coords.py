"""Spherical/Cartesian coordinates (port of ``cart2sph_np`` from
``fnssl_tpu/core/coords.py``; its JAX half is not ported yet)."""
from __future__ import annotations

import numpy as np


def cart2sph_np(cart):
    """Host-numpy variant in the reference Dataset convention
    (FN-SSL/Dataset.py:44-50): columns (r, elevation-from-+z, azimuth)."""
    xy2 = cart[..., 0] ** 2 + cart[..., 1] ** 2
    return np.stack([
        np.sqrt(xy2 + cart[..., 2] ** 2),
        np.arctan2(np.sqrt(xy2), cart[..., 2]),
        np.arctan2(cart[..., 1], cart[..., 0])], axis=-1)
