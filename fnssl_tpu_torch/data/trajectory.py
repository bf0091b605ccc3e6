"""Random-trajectory scene dataset (parity: FN-SSL/Dataset.py:839-988).

Samples room geometry, T60/absorption, array placement, SNR, and per-source
line+sinusoid trajectories (25% of mobile draws collapse to static), pins
the source elevation to the array height, and derives the continuous DOA
stream in the array frame. Every draw is seeded per item, so scene idx→
content is reproducible across hosts (MyDistributedSampler semantics).

Port of ``fnssl_tpu/data/trajectory.py``, the same numpy code.
"""
from __future__ import annotations

import numpy as np

from fnssl_tpu_torch.core.coords import cart2sph_np
from fnssl_tpu_torch.data.arrays import ArraySetup
from fnssl_tpu_torch.data.params import as_parameter
from fnssl_tpu_torch.data.scene import AcousticScene
from fnssl_tpu_torch.sim import beta_sabine_estimation


class RandomTrajectoryDataset:
    def __init__(self, sourceDataset, num_source, source_state, room_sz,
                 T60, abs_weights, array_setup: ArraySetup, array_pos,
                 noiseDataset, SNR, nb_points: int, min_dis,
                 c: float = 343.0, transforms=None, seed: int = 0):
        assert np.count_nonzero(array_setup.orV) == 1, \
            "array_setup.orV must be parallel to an axis"
        self.sourceDataset = sourceDataset
        self.num_source = as_parameter(num_source)
        self.source_state = source_state
        self.room_sz = as_parameter(room_sz)
        self.T60 = as_parameter(T60)
        self.abs_weights = as_parameter(abs_weights)
        self.array_setup = array_setup
        self.array_pos = as_parameter(array_pos)
        self.mic_scale = as_parameter(array_setup.mic_scale)
        self.min_dis = as_parameter(min_dis)
        self.noiseDataset = noiseDataset
        self.SNR = as_parameter(SNR)
        self.nb_points = nb_points
        self.fs = sourceDataset.fs
        self.c = c
        self.transforms = transforms
        self.seed = seed

    def __len__(self):
        return len(self.sourceDataset)

    def __getitem__(self, idx):
        seed = None
        if isinstance(idx, tuple):  # (idx, per-item seed) sampler contract
            idx, seed = idx
        if idx < 0:
            idx = len(self) + idx
        scene = self.get_random_scene(idx, seed)
        mic_signals = scene.simulate()
        if self.transforms is not None:
            for t in self.transforms:
                mic_signals, scene = t(mic_signals, scene)
        return mic_signals, scene

    def get_random_scene(self, idx: int, seed: int | None = None
                         ) -> AcousticScene:
        rng = np.random.default_rng(
            self.seed + idx if seed is None else seed)
        source_signal, vad = self.sourceDataset.get(idx, rng)
        num_source = int(self.num_source.get_value(rng))

        room_sz = self.room_sz.get_value(rng)
        t60 = float(self.T60.get_value(rng))
        abs_weights = self.abs_weights.get_value(rng)
        beta = beta_sabine_estimation(room_sz, t60, abs_weights)

        array_pos = self.array_pos.get_value(rng) * room_sz
        mic_scale = self.mic_scale.get_value(rng)
        mic_pos = array_pos + self.array_setup.mic_pos * mic_scale
        noise_signal = self.noiseDataset.get_random_noise(
            self.array_setup.mic_pos * mic_scale, rng)

        # source region: the half-space in front of the (planar) array
        src_min = np.zeros(3)
        src_max = np.asarray(room_sz, float).copy()
        axis = np.nonzero(self.array_setup.orV)[0]
        if self.array_setup.arrayType == "planar":
            if np.sum(self.array_setup.orV) > 0:
                src_min[axis] = array_pos[axis]
            else:
                src_max[axis] = array_pos[axis]
        src_min[axis] += self.min_dis.get_value(rng)

        nsample = source_signal.shape[0]
        timestamps = (np.arange(self.nb_points) * nsample
                      / self.fs / self.nb_points)
        t = np.arange(nsample) / self.fs
        traj_pts = np.zeros((self.nb_points, 3, num_source))
        trajectory = np.zeros((nsample, 3, num_source))
        doa = np.zeros((nsample, 2, num_source))
        for s in range(num_source):
            if self.source_state == "static":
                pos = src_min + rng.random(3) * (src_max - src_min)
                traj_pts[:, :, s] = pos
            elif self.source_state == "mobile":
                p0 = src_min + rng.random(3) * (src_max - src_min)
                p1 = src_min + rng.random(3) * (src_max - src_min)
                amax = np.min(np.stack([p0 - src_min, src_max - p0,
                                        p1 - src_min, src_max - p1]), axis=0)
                amp = rng.random(3) * np.minimum(amax, 1.0)
                w = 2 * np.pi / self.nb_points * rng.random(3) * 2
                traj_pts[:, :, s] = np.linspace(p0, p1, self.nb_points)
                traj_pts[:, :, s] += amp * np.sin(
                    w * np.arange(self.nb_points)[:, None])
                if rng.random() < 0.25:
                    traj_pts[:, :, s] = p0
            else:
                raise ValueError(self.source_state)
            # elevation pinned to the array height (Dataset.py:965)
            traj_pts[:, 2, :] = mic_pos[0, 2]
            for d in range(3):
                trajectory[:, d, s] = np.interp(t, timestamps,
                                                traj_pts[:, d, s])
            doa[:, :, s] = cart2sph_np(
                trajectory[:, :, s] - array_pos)[:, 1:3]

        scene = AcousticScene(
            room_sz=room_sz, T60=t60, beta=beta,
            noise_signal=noise_signal, SNR=float(self.SNR.get_value(rng)),
            source_signal=source_signal[:, :num_source], fs=self.fs,
            array_setup=self.array_setup, mic_pos=mic_pos,
            timestamps=timestamps, traj_pts=traj_pts,
            trajectory=trajectory, t=t, DOA=doa, c=self.c)
        scene.source_vad = vad[:, :num_source]
        return scene

    # reference-compatible alias
    getRandomScene = get_random_scene
