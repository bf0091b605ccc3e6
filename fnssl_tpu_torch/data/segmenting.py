"""Segmenting transform: per-sample DOA/VAD → per-segment labels.

Parity: FN-SSL/Dataset.py:759-837 ``Segmenting_SRPDNN``. Defaults
K=3328, step=3072 = 12 STFT frames · hop 256 (Train.py:43), producing one
label per model output frame. The circular-mean handling of azimuth wraps
(±π jumps inside a window) matches the reference exactly.

Port of ``fnssl_tpu/data/segmenting.py``, the same numpy code.
"""
from __future__ import annotations

import numpy as np


class Segmenting:
    def __init__(self, K: int = 3328, step: int = 3072, window=None):
        self.K = K
        self.step = step
        if window is None:
            self.w = np.ones(K)
        elif callable(window):
            self.w = window(K)
        else:
            self.w = np.asarray(window)
            assert len(self.w) == K

    def __call__(self, x: np.ndarray, acoustic_scene):
        L = x.shape[0]
        if self.K > L or self.step > L:
            raise ValueError("window size/step larger than signal")
        n_w = int(np.floor(L / self.step - self.K / self.step + 1))

        doa = acoustic_scene.DOA            # (nsample, 2, ns)
        num_source = doa.shape[2]
        pad = n_w * self.step + self.K - L
        doa = np.concatenate(
            [doa, np.tile(doa[-1:], (pad, 1, 1))], axis=0)

        doaw_all = []
        for s in range(num_source):
            idx = (np.arange(n_w)[:, None] * self.step
                   + np.arange(self.K)[None, :])
            doaw = doa[idx, :, s]           # (n_w, K, 2)
            # unwrap ±π azimuth jumps within a window before averaging
            jump = np.abs(np.diff(doaw[..., 1], axis=1)).max(axis=1) > np.pi
            azi = doaw[..., 1].copy()
            azi[jump] = np.where(azi[jump] < 0, azi[jump] + 2 * np.pi,
                                 azi[jump])
            doaw = np.stack([doaw[..., 0], azi], axis=-1).mean(axis=1)
            doaw[doaw[:, 1] > np.pi, 1] -= 2 * np.pi
            doaw_all.append(doaw)
        acoustic_scene.DOAw = np.stack(doaw_all, axis=2)  # (nseg, 2, ns)

        if hasattr(acoustic_scene, "mic_vad"):
            vad = np.concatenate(
                [acoustic_scene.mic_vad,
                 np.zeros(L - len(acoustic_scene.mic_vad))])
            idx = (np.arange(n_w)[:, None] * self.step
                   + np.arange(self.K)[None, :])
            acoustic_scene.mic_vad = vad[idx]             # (nseg, K)

        if hasattr(acoustic_scene, "mic_vad_sources"):
            vs = acoustic_scene.mic_vad_sources           # (nsample, ns)
            vs = np.concatenate(
                [vs, np.zeros((L - vs.shape[0], vs.shape[1]))], axis=0)
            idx = (np.arange(n_w)[:, None] * self.step
                   + np.arange(self.K)[None, :])
            acoustic_scene.mic_vad_sources = np.stack(
                [vs[idx, s] for s in range(vs.shape[1])],
                axis=2)                                   # (nseg, K, ns)

        acoustic_scene.tw = (np.arange(0, L - self.K, self.step)
                             / acoustic_scene.fs)
        return x, acoustic_scene
