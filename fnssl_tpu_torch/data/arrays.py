"""Microphone-array geometry: ``ArraySetup`` and the FN-SSL 2-mic array.

Parity: FN-SSL/Dataset.py:85-118. The DICIT, linear, circular and
Westlake arrays of the JAX module wait for the LOCATA, IPDnet and
IPDnet2 ports.

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
