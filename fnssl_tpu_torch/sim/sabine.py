"""Sabine reverberation helpers (gpuRIR-equivalent API surface).

Parity targets: the gpuRIR calls at FN-SSL/Dataset.py:141-152,916
(`beta_SabineEstimation`, `att2t_SabineEstimator`, `t2n`).

Port of ``fnssl_tpu/sim/sabine.py``, the same numpy code.
"""
from __future__ import annotations

import numpy as np


def beta_sabine_estimation(room_sz, t60: float,
                           abs_weights=(1.0,) * 6) -> np.ndarray:
    """Per-wall reflection coefficients matching a target T60.

    Sabine: T60 = 0.161 V / A with A = Σ α_i S_i. Walls share a base
    absorption scaled by ``abs_weights`` (order x0,x1,y0,y1,z0,z1).
    Returns beta (6,) with β_i = sqrt(1 - α_i).
    """
    L = np.asarray(room_sz, np.float64)
    w = np.asarray(abs_weights, np.float64)
    v = float(np.prod(L))
    surf = np.array([L[1] * L[2], L[1] * L[2],
                     L[0] * L[2], L[0] * L[2],
                     L[0] * L[1], L[0] * L[1]])
    if t60 <= 0:
        return np.zeros(6)
    alpha = 0.161 * v / (t60 * float(np.sum(surf * w)))
    alphas = np.clip(w * alpha, 0.0, 0.9999)
    return np.sqrt(1.0 - alphas)


def att2t_sabine_estimator(att_db: float, t60: float) -> float:
    """Time for the RIR to decay ``att_db`` given T60 (linear dB decay)."""
    return att_db / 60.0 * t60


def t2n(time: float, room_sz, c: float = 343.0) -> list[int]:
    """Image-source order per dimension covering propagation time ``time``."""
    L = np.asarray(room_sz, np.float64)
    return [int(np.ceil(c * time / (2.0 * li))) for li in L]
