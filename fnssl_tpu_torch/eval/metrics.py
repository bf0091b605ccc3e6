"""Localization metrics: ACC/MAE (single source), ACC/MDR/FAR/MAE/RMSE
(multi-source, Hungarian-matched).

Parity: FN-SSL/Module.py:101-317 ``getMetric``. Host-side numpy — the
per-frame Hungarian assignment is inherently data-dependent, so it stays
off-device (scipy's C++ linear_sum_assignment), exactly as in the
reference. The single-source path is fully vectorized.

All angles in degrees.

Port of ``fnssl_tpu/eval/metrics.py``, the same numpy code.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

_INF = 10000.0
_EPS = 1e-5


def angular_error(est: np.ndarray, gt: np.ndarray, mode: str) -> np.ndarray:
    """Angular error in degrees (Module.py:292-311).

    'azi': circular difference; 'ele': plain difference; 'aziele':
    great-circle angle — est/gt lead with the (ele, azi) axis.
    """
    if mode == "azi":
        return np.abs((est - gt + 180.0) % 360.0 - 180.0)
    if mode == "ele":
        return np.abs(est - gt)
    if mode == "aziele":
        ele_gt, azi_gt = np.deg2rad(gt[0]), np.deg2rad(gt[1])
        ele_est, azi_est = np.deg2rad(est[0]), np.deg2rad(est[1])
        aux = (np.cos(ele_gt) * np.cos(ele_est)
               + np.sin(ele_gt) * np.sin(ele_est) * np.cos(azi_gt - azi_est))
        aux = np.clip(aux, -0.99999, 0.99999)
        return np.abs(np.degrees(np.arccos(aux)))
    raise ValueError(f"unknown angle-error mode {mode!r}")


def get_metric_single(doa_gt, vad_gt, doa_est, vad_est,
                      ae_mode=("azi",), ae_th: float = 30.0,
                      use_vad: bool = True,
                      vad_th=(2 / 3, 2 / 3)) -> dict[str, float]:
    """Single-source ACC/MAE (Module.py:143-181).

    Args: doa_* (nb, nt, 2, ns) degrees; vad_* (nb, nt, ns).
    ACC = fraction of gt-active frames with azimuth error < ae_th (further
    gated by est VAD); MAE = mean error over gt-active frames per ae_mode.
    """
    doa_gt, doa_est = np.asarray(doa_gt), np.asarray(doa_est)
    nb, nt, _, ns = doa_est.shape
    if not use_vad:
        vad_gt = np.ones((nb, nt, ns))
        vad_est = np.ones((nb, nt, ns))
    vad_gt = np.asarray(vad_gt) > vad_th[0]
    vad_est = (np.asarray(vad_est) > vad_th[1]) * vad_gt

    azi_err = angular_error(doa_est[:, :, 1], doa_gt[:, :, 1], "azi")
    ele_err = angular_error(doa_est[:, :, 0], doa_gt[:, :, 0], "ele")
    aziele_err = angular_error(doa_est.transpose(2, 0, 1, 3),
                               doa_gt.transpose(2, 0, 1, 3), "aziele")
    corr = (azi_err < ae_th).astype(np.float64) * vad_est
    # eps guard for zero active frames (the reference NaNs here)
    act = max(vad_gt.sum(), _EPS)
    metric = {"ACC": float(corr.sum() / act)}
    errs = {"ele": ele_err, "azi": azi_err, "aziele": aziele_err}
    mae = [float((vad_gt * errs[m]).sum() / act) for m in ae_mode]
    metric["MAE"] = mae[0] if len(mae) == 1 else mae
    return metric


def get_metric_multiple(doa_gt, vad_gt, doa_est, vad_est,
                        ae_mode=("azi",), ae_th: float = 30.0,
                        use_vad: bool = True,
                        vad_th=(2 / 3, 0.2)) -> dict[str, float]:
    """Multi-source metrics with per-frame Hungarian matching
    (Module.py:184-283).

    Assignments whose azimuth error exceeds ae_th are invalidated; ACC is
    matched/active, MDR missed/active, FAR spurious/active, MAE/RMSE over
    matched pairs only. IPDnet2's inverted detection threshold
    (``invert_est_vad``) waits for the IPDnet2 port.
    """
    doa_gt, doa_est = np.asarray(doa_gt), np.asarray(doa_est)
    nbatch = doa_est.shape[0]
    nmode = len(ae_mode)
    acc = np.zeros(nbatch)
    mdr = np.zeros(nbatch)
    far = np.zeros(nbatch)
    mae = np.zeros((nbatch, nmode))
    rmse = np.zeros((nbatch, nmode))

    for b in range(nbatch):
        d_gt, d_est = doa_gt[b], doa_est[b]
        nt, _, ns_gt = d_gt.shape
        ns_est = d_est.shape[2]
        if not use_vad:
            v_gt = np.ones((nt, ns_gt), bool)
            v_est = np.ones((nt, ns_est), bool)
        else:
            v_gt = np.asarray(vad_gt[b]) > vad_th[0]
            v_est = np.asarray(vad_est[b]) > vad_th[1]
        k_gt = v_gt.sum(axis=1)
        # est VAD only counts in frames where any gt source is active
        v_est = v_est * (k_gt > 0)[:, None]
        k_est = v_est.sum(axis=1)

        corr = np.zeros((nt, ns_gt))
        errs = {m: np.zeros((nt, ns_gt)) for m in ("azi", "ele", "aziele")}
        for t in range(nt):
            n_g, n_e = int(k_gt[t]), int(k_est[t])
            if n_g == 0 or n_e == 0:
                continue
            gt = d_gt[t][:, v_gt[t]]          # (2, n_g)
            est = d_est[t][:, v_est[t]]       # (2, n_e)
            d_az = angular_error(est[1][None, :], gt[1][:, None], "azi")
            d_el = angular_error(est[0][None, :], gt[0][:, None], "ele")
            d_azel = angular_error(est[:, None, :], gt[:, :, None],
                                   "aziele")
            cost = np.where(d_az > ae_th, _INF, d_az)
            rows, cols = linear_sum_assignment(cost)
            for i, j in zip(rows, cols):
                if cost[i, j] != _INF:
                    corr[t, i] = 1
                    errs["azi"][t, i] = d_az[i, j]
                    errs["ele"][t, i] = d_el[i, j]
                    errs["aziele"][t, i] = d_azel[i, j]

        k_corr = corr.sum()
        total_gt = k_gt.sum()
        acc[b] = k_corr / total_gt
        mdr[b] = (total_gt - k_corr) / total_gt
        far[b] = (k_est.sum() - k_corr) / total_gt
        for mi, m in enumerate(ae_mode):
            e = errs[m]
            mae[b, mi] = (e * corr).sum() / (k_corr + _EPS)
            rmse[b, mi] = np.sqrt((e * e * corr).sum() / (k_corr + _EPS))

    def fold(v):
        v = v.mean(axis=0)
        if np.ndim(v) == 0 or v.size == 1:
            return float(np.asarray(v).reshape(()))
        return v.tolist()

    return {"ACC": fold(acc), "MDR": fold(mdr), "FAR": fold(far),
            "MAE": fold(mae), "RMSE": fold(rmse)}
