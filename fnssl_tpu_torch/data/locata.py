"""LOCATA challenge dataset reader (port of ``fnssl_tpu/data/locata.py``,
the same numpy/scipy code, draw for draw; the tab-separated pose, time and
VAD streams are read with the ``csv`` module instead of pandas).

Parity: FN-SSL/Dataset.py:548-755 ``LocataDataset``: per-task recording
walk, 48→16 kHz decimation, leading-silence strip, array pose/rotation
from the position txt, source trajectory interpolation, DOA in the
rotated array frame, and the dataset-VAD 48 kHz→16 kHz resampling.

The reference's VAD-resample loop contains an unreachable-NameError
branch (``VAD[cnt: end]`` with undefined names, Dataset.py:674) on
length mismatch; here the tail is filled with the last VAD value.
"""
from __future__ import annotations

import csv
import os
from copy import deepcopy

import numpy as np
import scipy.signal

from fnssl_tpu_torch.core.coords import cart2sph_np
from fnssl_tpu_torch.data.arrays import dicit_array_setup
from fnssl_tpu_torch.data.scene import AcousticScene
from fnssl_tpu_torch.data.vad import frame_vad
from fnssl_tpu_torch.utils.audio_io import read_audio


class _Table(dict):
    """A tab-separated file with a header row: column name → the column
    as a float64 array (converted when first read)."""

    def __getitem__(self, name):
        return np.asarray(super().__getitem__(name), np.float64)


def _read_tsv(path) -> _Table:
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    head, body = rows[0], [r for r in rows[1:] if r]
    return _Table({k: [r[i] for r in body] for i, k in enumerate(head)})


class LocataDataset:
    def __init__(self, paths, array: str = "dicit", fs: int = 16000,
                 tasks=(3, 5), recording=None, dev: bool = True,
                 transforms=None, return_acoustic_scene: bool = False):
        assert array in ("dummy", "eigenmike", "benchmark2", "dicit")
        if isinstance(paths, str):
            paths = [paths]
        self.array = array
        self.fs = fs
        self.dev = dev
        self.transforms = transforms
        self.return_acoustic_scene = return_acoustic_scene
        if array == "dicit":
            self.array_setup = dicit_array_setup()
        else:
            self.array_setup = None
        self.directories = []
        for path in paths:
            for task in tasks:
                task_path = os.path.join(path, f"task{task}")
                if not os.path.isdir(task_path):
                    continue
                for rec in sorted(os.listdir(task_path)):
                    d = os.path.join(task_path, rec, array)
                    if os.path.isdir(d):
                        self.directories.append(d)
        self.directories.sort()

    def __len__(self):
        return len(self.directories)

    def _decimate(self, sig, fs):
        if fs > self.fs:
            sig = scipy.signal.decimate(sig, int(fs / self.fs), axis=0)
        elif fs < self.fs:
            raise ValueError(f"file fs {fs} < target {self.fs}")
        return sig

    def __getitem__(self, idx):
        directory = self.directories[idx].replace("\\", "/")
        mic_signals, fs0 = read_audio(os.path.join(
            directory, f"audio_array_{self.array}.wav"))
        mic_signals = self._decimate(mic_signals, fs0)

        # strip leading silence (Dataset.py:609-611)
        start = int(np.argmax(
            mic_signals[:, 0] > mic_signals[:, 0].max() * 0.15))
        mic_signals = mic_signals[start:]
        t = (np.arange(len(mic_signals)) + start) / self.fs

        df = _read_tsv(os.path.join(
            directory, f"position_array_{self.array}.txt"))
        array_pos = np.stack([df["x"], df["y"], df["z"]], axis=-1)
        array_rotation = np.zeros((array_pos.shape[0], 3, 3))
        for i in range(3):
            for j in range(3):
                array_rotation[:, i, j] = df[f"rotation_{i + 1}{j + 1}"]

        df = _read_tsv(os.path.join(directory, "required_time.txt"))
        required = df["hour"] * 3600 + df["minute"] * 60 + df["second"]
        timestamps = required - required[0]

        sources_signal = doa = sources_pos = None
        sensor_vads = []
        if self.dev:
            names = sorted(
                f[13:-4] for f in os.listdir(directory)
                if f.startswith("audio_source") and f.endswith(".wav"))
            sigs, positions, trajs = [], [], []
            fs_src = fs0
            for name in names:
                s, fs_src = read_audio(
                    os.path.join(directory, f"audio_source_{name}.wav"))
                s = self._decimate(s, fs_src)
                sigs.append(s[start: start + len(t)])
                df = _read_tsv(os.path.join(
                    directory, f"position_source_{name}.txt"))
                pos = np.stack([df["x"], df["y"], df["z"]], axis=-1)
                positions.append(pos)
                trajs.append(np.stack(
                    [np.interp(t, timestamps, pos[:, i])
                     for i in range(3)], axis=-1))
                arr_dir = directory.split("/")[-1]
                vad_file = os.path.join(directory,
                                        f"VAD_{arr_dir}_{name}.txt")
                vad48 = _read_tsv(vad_file)["VAD"]
                sensor_vads.append(self._resample_vad(vad48, t, fs_src))
            sources_signal = np.stack(sigs, axis=0)
            sources_pos = np.stack(positions, axis=0)
            trajectories = np.stack(trajs, axis=0)
            sensor_vads = np.stack(sensor_vads, axis=0)

            doa = np.zeros(trajectories.shape[:2] + (2,))
            for s in range(sources_pos.shape[0]):
                # row-vector × rotation per timestamp (Dataset.py:691)
                local = np.einsum("tj,tjk->tk",
                                  sources_pos[s] - array_pos,
                                  array_rotation)
                local_i = np.stack(
                    [np.interp(t, timestamps, local[:, i])
                     for i in range(3)], axis=-1)
                doa[s] = cart2sph_np(local_i)[:, 1:3]

        mic_pos = (array_rotation[0] @ (
            self.array_setup.mic_pos
            * self.array_setup.mic_scale.get_value()).T).T + array_pos[0]
        scene = AcousticScene(
            room_sz=np.full((3, 1), np.nan), T60=np.nan,
            beta=np.full((6, 1), np.nan), noise_signal=np.nan,
            SNR=np.nan,
            source_signal=(sources_signal.T if sources_signal is not None
                           else np.full((len(t), 1), np.nan)),
            fs=self.fs, array_setup=self.array_setup, mic_pos=mic_pos,
            timestamps=timestamps - start / self.fs,
            traj_pts=(sources_pos.transpose(1, 2, 0)
                      if sources_pos is not None else None),
            trajectory=(trajectories.transpose(1, 2, 0)
                        if doa is not None else None),
            t=t - start / self.fs,
            DOA=doa.transpose(1, 2, 0) if doa is not None else None,
            c=np.nan)

        if self.dev:
            vad = sensor_vads.T                   # dataset VAD
        else:
            vad = np.stack([frame_vad(mic_signals[:, 0], int(self.fs), 1)],
                           axis=1)
        scene.mic_vad_sources = deepcopy(vad)
        scene.mic_vad = vad.sum(axis=1) > 0.5

        if self.transforms is not None:
            for tr in self.transforms:
                mic_signals, scene = tr(mic_signals, scene)
        if self.return_acoustic_scene:
            return mic_signals.copy(), scene
        return mic_signals.copy(), {
            "doa": scene.DOAw.astype(np.float32),
            "vad_sources": scene.mic_vad_sources}

    def _resample_vad(self, vad48: np.ndarray, t: np.ndarray,
                      fs_src: float) -> np.ndarray:
        """48 kHz VAD stream → values at the 16 kHz sample times ``t``
        (Dataset.py:662-676), tail-filled instead of NameError-ing."""
        t48 = np.arange(len(vad48)) / fs_src
        idx = np.searchsorted(t48, t, side="right") - 1
        idx = np.clip(idx, 0, len(vad48) - 1)
        return vad48[idx].astype(np.float64)
