"""Noise synthesis: spatial white, spherical diffuse (ANF generator),
real-world multichannel recordings.

Parity: FN-SSL/Dataset.py:337-485 ``NoiseDataset`` — including the
Habets arbitrary-noise-field construction: per-frequency Cholesky of the
sinc spatial-coherence matrix applied in the STFT domain. The reference's
missing ``import copy, math`` bug (fixed upstream only in IPDnet) does not
carry over.

Port of ``fnssl_tpu/data/noise.py``, the same numpy code.
"""
from __future__ import annotations

import os

import numpy as np
import scipy.linalg
import scipy.signal


def gen_diffuse_noise(noise: np.ndarray, T: float, fs: int,
                      mic_pos: np.ndarray, nfft: int = 256,
                      c: float = 343.0,
                      type_nf: str = "spherical") -> np.ndarray:
    """Spherically-diffuse M-channel noise from one long mono recording.

    Splits ``noise`` into M independent channels and mixes them per
    frequency bin with the Cholesky factor of the sinc coherence matrix
    (Dataset.py:423-457).
    """
    m = mic_pos.shape[0]
    L = int(T * fs)
    noise = noise - np.mean(noise)
    noise_m = np.stack([noise[i * L:(i + 1) * L] for i in range(m)], axis=1)

    ww = 2 * np.pi * fs * np.arange(nfft // 2 + 1) / nfft
    dist = np.linalg.norm(mic_pos[:, None] - mic_pos[None, :], axis=-1)
    if type_nf == "spherical":
        dc = np.sinc(ww[None, None, :] * dist[:, :, None] / (c * np.pi))
    elif type_nf == "cylindrical":
        from scipy.special import jv
        dc = jv(0, ww[None, None, :] * dist[:, :, None] / c)
    else:
        raise ValueError(f"unknown noise field {type_nf!r}")
    eye = np.eye(m)[:, :, None]
    dc = dc * (1 - eye) + eye  # exact ones on the diagonal
    return mix_signals(noise_m, dc)


def mix_signals(noise: np.ndarray, dc: np.ndarray,
                method: str = "cholesky") -> np.ndarray:
    """Impose the spatial coherence ``dc`` (M, M, K/2+1) on M independent
    channels via STFT-domain mixing (Dataset.py:459-485)."""
    m = noise.shape[1]
    k = (dc.shape[2] - 1) * 2
    x = np.vstack([np.zeros((k // 2, m)), noise, np.zeros((k // 2, m))]).T
    _, _, spec = scipy.signal.stft(x, window="hann", nperseg=k,
                                   noverlap=3 * k // 4, nfft=k)
    out = np.zeros_like(spec)
    for bin_idx in range(1, k // 2 + 1):
        if method == "cholesky":
            cmat = scipy.linalg.cholesky(dc[:, :, bin_idx])
        elif method == "eigen":
            d, v = np.linalg.eig(dc[:, :, bin_idx])
            order = np.argsort(d)
            cmat = np.sqrt(np.diag(d[order])) @ v[:, order].T
        else:
            raise ValueError(f"unknown method {method!r}")
        out[:, bin_idx, :] = (spec[:, bin_idx, :].T @ np.conj(cmat)).T
    _, y = scipy.signal.istft(out, window="hann", nperseg=k,
                              noverlap=3 * k // 4, nfft=k)
    return y.T[k // 2: -k // 2, :]


class NoiseDataset:
    """Random noise source matching the reference contract.

    noise_type: Parameter over {'spatial_white', 'diffuse', 'real_world'}.
    """

    def __init__(self, T: float, fs: int, nmic: int, noise_type,
                 noise_path: str | None = None, c: float = 343.0):
        self.T, self.fs, self.nmic, self.c = T, fs, nmic, c
        self.noise_type = noise_type
        self.paths: list[str] = []
        if noise_path is not None:
            for root, _, files in os.walk(noise_path):
                self.paths += [os.path.join(root, f) for f in files
                               if f.endswith(".wav")]
            self.paths.sort()

    def _load_tiled(self, rng, nsample_desired: int,
                    multichannel: bool) -> np.ndarray:
        from fnssl_tpu_torch.utils.audio_io import read_audio

        path = self.paths[rng.integers(0, len(self.paths))]
        noise, fs = read_audio(path)
        if fs != self.fs:
            noise = scipy.signal.resample_poly(noise, up=self.fs, down=fs)
        tiled = noise
        while tiled.shape[0] < nsample_desired:
            tiled = np.concatenate([tiled, noise], axis=0)
        st = rng.integers(0, tiled.shape[0] - nsample_desired + 1)
        return tiled[st: st + nsample_desired]

    def get_random_noise(self, mic_pos: np.ndarray | None = None,
                         rng: np.random.Generator | None = None
                         ) -> np.ndarray:
        rng = rng if rng is not None else np.random.default_rng()
        noise_type = (self.noise_type.get_value(rng)
                      if hasattr(self.noise_type, "get_value")
                      else self.noise_type)
        nsample = int(self.T * self.fs)
        if noise_type == "spatial_white":
            return rng.standard_normal((nsample, self.nmic))
        if noise_type == "diffuse":
            mono = self._load_tiled(rng, nsample * self.nmic, False)
            return gen_diffuse_noise(mono, self.T, self.fs, mic_pos,
                                     c=self.c)
        if noise_type == "real_world":
            noise = self._load_tiled(rng, nsample, True)
            if noise.ndim != 2 or noise.shape[1] != self.nmic:
                raise ValueError("unexpected number of noise channels")
            return noise
        raise ValueError(f"unknown noise type {noise_type!r}")
