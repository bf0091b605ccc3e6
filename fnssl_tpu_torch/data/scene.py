"""Acoustic scene container + simulation + wav/npz persistence (port of
``fnssl_tpu/data/scene.py``; the unpickler maps the JAX package's class
paths to the port's classes).

Parity: FN-SSL/Dataset.py:120-201 (AcousticScene), FN-SSL/utils.py:138-164
(save/load contract: wav via soundfile + pickled ``__dict__`` in a ``.npz``
-named file) — reference-generated datasets are directly consumable and
vice versa. Simulation runs on the fnssl_tpu_torch.sim host engine instead of
gpuRIR; IPDnet's variant also keeps ``dp_mic_signals_sources``
(IPDnet/Dataset.py:159), asked for with ``keep_dp_signals``.
"""
from __future__ import annotations

import pickle

import numpy as np

from fnssl_tpu_torch.sim import (
    att2t_sabine_estimator, simulate_rir, simulate_trajectory, t2n)


def acoustic_power(s: np.ndarray) -> float:
    """Mean power over non-silent 512/256 windows (Dataset.py:28-42)."""
    w, o = 512, 256
    s = np.ascontiguousarray(s)
    sh = (s.size - w + 1, w)
    windows = np.lib.stride_tricks.as_strided(
        s, strides=s.strides * 2, shape=sh)[::o]
    power = np.mean(windows ** 2, axis=-1)
    th = 0.01 * power.max()
    active = power[power > th]
    # all-silent guard (absent in the reference, which NaNs here when a
    # source is fully gated off): fall back to the overall mean power
    if active.size == 0:
        return float(max(power.mean(), 1e-10))
    return float(np.mean(active))


class AcousticScene:
    """Scene description; attribute names match the reference pickle."""

    def __init__(self, room_sz, T60, beta, noise_signal, SNR, source_signal,
                 fs, array_setup, mic_pos, timestamps, traj_pts, trajectory,
                 t, DOA, c=343.0):
        self.room_sz = room_sz
        self.T60 = T60
        self.beta = beta
        self.noise_signal = noise_signal
        self.SNR = SNR
        self.source_signal = source_signal
        self.fs = fs
        self.array_setup = array_setup
        self.mic_pos = mic_pos
        self.timestamps = timestamps
        self.traj_pts = traj_pts
        self.trajectory = trajectory
        self.t = t
        self.DOA = DOA
        self.c = c

    @classmethod
    def empty(cls):
        return cls(*([[]] * 14), c=[])

    def simulate(self, keep_dp_signals: bool = False) -> np.ndarray:
        """Reverberant + direct-path simulation, noise at target SNR,
        per-source VAD propagated through the direct-path RIRs."""
        if self.T60 == 0:
            tmax = 0.1
            nb_img = [1, 1, 1]
        else:
            # reference splits ISM/diffuse at Tdiff; our engine runs full
            # ISM to Tmax (denser tail, no diffuse approximation)
            tmax = att2t_sabine_estimator(40.0, self.T60)
            nb_img = t2n(tmax, self.room_sz, self.c)

        num_source = self.traj_pts.shape[-1]
        nsample = len(self.t)
        mic_signals_sources, dp_signals_sources, dp_rirs_sources = [], [], []
        for s in range(num_source):
            rirs = simulate_rir(self.room_sz, self.beta,
                                self.traj_pts[:, :, s], self.mic_pos,
                                nb_img, tmax, self.fs, self.c)
            sig = simulate_trajectory(self.source_signal[:, s], rirs,
                                      self.timestamps, self.fs)
            mic_signals_sources.append(sig[:nsample])
            dp_rirs = simulate_rir(self.room_sz, np.zeros(6),
                                   self.traj_pts[:, :, s], self.mic_pos,
                                   [0, 0, 0], 0.1, self.fs, self.c)
            dp_sig = simulate_trajectory(self.source_signal[:, s], dp_rirs,
                                         self.timestamps, self.fs)
            dp_signals_sources.append(dp_sig[:nsample])
            dp_rirs_sources.append(dp_rirs)

        mic_signals = np.sum(mic_signals_sources, axis=0)
        dp_mic_signals = np.sum(dp_signals_sources, axis=0)
        if keep_dp_signals:
            self.dp_mic_signals_sources = np.stack(
                dp_signals_sources, axis=2)  # (nsample, nch, ns)

        if self.noise_signal is None or len(self.noise_signal) == 0:
            self.noise_signal = np.random.standard_normal(mic_signals.shape)
        ac_pow = np.mean([acoustic_power(dp_mic_signals[:, i])
                          for i in range(dp_mic_signals.shape[1])])
        noise_pow = np.mean([acoustic_power(self.noise_signal[:, i])
                             for i in range(self.noise_signal.shape[1])])
        scale = np.sqrt(ac_pow / 10 ** (self.SNR / 10)) / np.sqrt(noise_pow)
        mic_signals = mic_signals + scale * self.noise_signal[:nsample]

        if hasattr(self, "source_vad"):
            vad_sources = []
            for s in range(num_source):
                vad = simulate_trajectory(self.source_vad[:, s],
                                          dp_rirs_sources[s],
                                          self.timestamps, self.fs)
                vad = vad[:nsample]
                vad_sources.append(vad.mean(axis=1) > vad.max() * 1e-3)
            self.mic_vad_sources = np.stack(vad_sources, axis=1)
            self.mic_vad = self.mic_vad_sources.sum(axis=1) > 0.5

        return mic_signals


def save_file(mic_signal, acoustic_scene: AcousticScene,
              sig_path: str | None, acous_path: str | None):
    if sig_path is not None:
        from fnssl_tpu_torch.utils.audio_io import write_audio
        write_audio(sig_path, mic_signal, acoustic_scene.fs)
    if acous_path is not None:
        with open(acous_path, "wb") as f:
            f.write(pickle.dumps(acoustic_scene.__dict__))


# Packages whose scene classes the unpickler maps to the port's own: the
# reference's ``Dataset`` module, the JAX package and the port. A name
# under one of them is never imported (importing fnssl_tpu imports jax).
_SCENE_MODULES = ("Dataset", "fnssl_tpu", "fnssl_tpu_torch")


class _CompatUnpickler(pickle.Unpickler):
    """Resolve the scene classes named by reference-, JAX- and
    port-written pickles (``Dataset.ArraySetup``,
    ``fnssl_tpu.data.params.Parameter``, ...) to the port's classes
    without importing the module that wrote them."""

    def find_class(self, module, name):
        from fnssl_tpu_torch.data.arrays import ArraySetup
        from fnssl_tpu_torch.data.params import Parameter

        classes = {"ArraySetup": ArraySetup, "Parameter": Parameter,
                   "AcousticScene": AcousticScene}
        if name in ("ArraySetup", "Parameter"):
            return classes[name]
        if module.split(".")[0] in _SCENE_MODULES:
            if name not in classes:
                raise pickle.UnpicklingError(
                    f"unknown scene class {module}.{name}")
            return classes[name]
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            if name == "AcousticScene":
                return AcousticScene
            raise


def load_file(acoustic_scene: AcousticScene, sig_path: str | None,
              acous_path: str | None):
    mic_signal = None
    if sig_path is not None:
        from fnssl_tpu_torch.utils.audio_io import read_audio
        mic_signal, _ = read_audio(sig_path)
    if acous_path is not None:
        with open(acous_path, "rb") as f:
            acoustic_scene.__dict__ = _CompatUnpickler(f).load()
    if sig_path is None:
        return acoustic_scene
    if acous_path is None:
        return mic_signal
    return mic_signal, acoustic_scene
