"""Localization visualizations (matplotlib, Agg backend, on the host;
port of ``fnssl_tpu/eval/vis.py``, the same code).

Parity: visDOA (FN-SSL/Module.py:319-373) azimuth scatter of GT vs
estimates with VAD gating; locata_plot (FN-SSL/utils.py:166-187) 12-panel
LOCATA task grid.
"""
from __future__ import annotations

import numpy as np


def vis_doa(doa_gt, vad_gt, doa_est, vad_est, vad_th, time_stamp,
            doa_invalid: float = 200.0):
    """Azimuth-vs-time scatter. Angles in degrees.

    Args: doa_* (nt, 2, ns); vad_* (nt, ns); vad_th (gt_th, est_th).
    Returns the matplotlib.pyplot module with the figure drawn (the
    reference's return contract).
    """
    import matplotlib.pyplot as plt

    plt.switch_backend("agg")
    doa_gt, doa_est = np.asarray(doa_gt), np.asarray(doa_est)
    vad_gt, vad_est = np.asarray(vad_gt), np.asarray(vad_est)

    any_active = (vad_gt.sum(-1) > 0)[:, None, None]
    gt_active = (vad_gt > vad_th[0])[:, None, :]
    est_active = (vad_est > vad_th[1])[:, None, :] & any_active
    gt_v = np.where(np.broadcast_to(gt_active, doa_gt.shape),
                    doa_gt, doa_invalid)
    gt_sil = np.where(~np.broadcast_to(gt_active, doa_gt.shape),
                      doa_gt, doa_invalid)
    est_v = np.where(np.broadcast_to(est_active, doa_est.shape),
                     doa_est, doa_invalid)

    plt.subplot(1, 1, 1)
    plt.grid(linestyle=":", color="silver")
    for s in range(doa_gt.shape[-1]):
        h_sil = plt.scatter(time_stamp, gt_sil[:, 1, s], label="GT_silence",
                            c="whitesmoke", marker=".", linewidth=1)
        h_gt = plt.scatter(time_stamp, gt_v[:, 1, s], label="GT",
                           c="lightgray", marker="o", linewidth=1.5)
    for s in range(doa_est.shape[-1]):
        h_est = plt.scatter(time_stamp, est_v[:, 1, s], label="EST",
                            c="firebrick", marker=".", linewidth=0.8)
    plt.legend(handles=[h_sil, h_gt, h_est])
    plt.xlabel("Time [s]")
    plt.ylabel("Azimuth [º]")
    plt.ylim(0, 180)
    return plt


def locata_plot(result_path: str, save_fig_path: str, bias: float = 4.0,
                n_tasks: int = 12, seg_samples: int = 4096,
                fs: int = 16000):
    """12-panel LOCATA GT-vs-EST grid from the per-task npy dumps."""
    import matplotlib.pyplot as plt

    plt.switch_backend("agg")
    plt.figure(figsize=(16, 8), dpi=300)
    for k in range(n_tasks):
        doa_gt = np.load(f"{result_path}{k}_gt.npy")
        doa_est = np.load(f"{result_path}{k}_est.npy") - bias
        vad_gt = np.load(f"{result_path}{k}_vadgt.npy")
        vad_sign = np.where(vad_gt < 2 / 3, -1.0, 1.0)
        plt.subplot(3, 4, k + 1)
        plt.subplots_adjust(wspace=0.3, hspace=0.3)
        x = np.arange(doa_gt.shape[1]) * seg_samples / fs
        plt.scatter(x, doa_gt[0, :, 1, 0], s=5, c="grey", linewidth=0.8,
                    label="GT")
        plt.scatter(x, doa_est[0, :, 1, 0] * vad_sign[0, :, 0], s=3,
                    c="firebrick", linewidth=0.8, label="EST")
        plt.xlabel("Time [s]")
        plt.ylabel("DOA[°]")
        plt.ylim((0, 180))
        plt.grid()
        plt.legend(loc=0, prop={"size": 4})
    plt.savefig(save_fig_path + "locata_fig.jpg")
    return plt
