"""Microphone-array geometry: ``ArraySetup`` and the FN-SSL 2-mic array.

Parity: FN-SSL/Dataset.py:85-118 (ArraySetup, dual-channel, the 15-mic
DICIT array of LOCATA), IPDnet2/utils_.py:11-46 (circular generator, the
Westlake 32-mic array that IPDnet2 trains on).

Port of ``fnssl_tpu/data/arrays.py``, the same numpy code.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from fnssl_tpu_torch.data.params import Parameter


class ArraySetup(NamedTuple):
    arrayType: str
    orV: np.ndarray
    mic_scale: Parameter
    mic_pos: np.ndarray
    mic_orV: np.ndarray | None
    mic_pattern: str


def dualch_array_setup() -> ArraySetup:
    """2-mic linear array at ±4 cm (FN-SSL training array)."""
    return ArraySetup(
        arrayType="planar", orV=np.array([0.0, 1.0, 0.0]),
        mic_scale=Parameter(1),
        mic_pos=np.array([(-0.04, 0.0, 0.0), (0.04, 0.0, 0.0)]),
        mic_orV=None, mic_pattern="omni")


def dicit_array_setup() -> ArraySetup:
    """15-mic DICIT planar array (LOCATA)."""
    x = np.array([0.96, 0.64, 0.32, 0.16, 0.08, 0.04, 0.00, 0.96,
                  -0.04, -0.08, -0.16, -0.32, -0.64, -0.96, -0.96])
    z = np.zeros(15)
    z[7] = z[14] = 0.32
    mic_pos = np.stack([x, np.zeros(15), z], axis=1)
    return ArraySetup(
        arrayType="planar", orV=np.array([0.0, 1.0, 0.0]),
        mic_scale=Parameter(1), mic_pos=mic_pos,
        mic_orV=np.tile(np.array([[0.0, 1.0, 0.0]]), (15, 1)),
        mic_pattern="omni")


def linear_array_setup(nmic: int = 2, spacing: float = 0.08
                       ) -> ArraySetup:
    """Generic centered linear array (IPDnet 'linear' arrayType)."""
    x = (np.arange(nmic) - (nmic - 1) / 2) * spacing
    return ArraySetup(
        arrayType="linear", orV=np.array([0.0, 1.0, 0.0]),
        mic_scale=Parameter(1),
        mic_pos=np.stack([x, np.zeros(nmic), np.zeros(nmic)], axis=1),
        mic_orV=None, mic_pattern="omni")


def circular_array_geometry(radius: float, mic_num: int) -> np.ndarray:
    angles = np.arange(mic_num) * 2 * np.pi / mic_num
    return radius * np.stack(
        [np.cos(angles), np.sin(angles), np.zeros(mic_num)], axis=1)


def audiowu_high_array_geometry() -> np.ndarray:
    """Westlake audio-lab 32-mic array: 3 concentric 8-mic circles
    (R=3/6/9 cm) + 3 linear + 4 vertical mics, mic 0 at origin."""
    r = 0.03
    pos = np.zeros((32, 3))
    pos[1:9] = circular_array_geometry(r, 8)
    pos[9:17] = circular_array_geometry(2 * r, 8)
    pos[17:25] = circular_array_geometry(3 * r, 8)
    pos[25] = [-4 * r, 0, 0]
    pos[26] = [4 * r, 0, 0]
    pos[27] = [5 * r, 0, 0]
    length = 0.045
    pos[28] = [0, 0, 2 * length]
    pos[29] = [0, 0, length]
    pos[30] = [0, 0, -length]
    pos[31] = [0, 0, -2 * length]
    return pos
