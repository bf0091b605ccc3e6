"""Dataset generation entry (parity: FN-SSL/Simu.py:1-77).

Writes N (wav, pickled-scene npz) pairs with the FN-SSL stage parameters:
T=4.79 s, 50 trajectory points, rooms 6×6×2.5–10×8×6 m, T60 0.2–1.3 s,
SNR −5–15 dB, 2-mic ±4 cm array, diffuse-capable noise.

Port of ``fnssl_tpu/data/simu.py``, the same numpy code, with IPDnet's
stage config (``make_ipdnet_trajectory_dataset``).
"""
from __future__ import annotations

import os

import numpy as np

from fnssl_tpu_torch.data.arrays import dualch_array_setup
from fnssl_tpu_torch.data.noise import NoiseDataset
from fnssl_tpu_torch.data.params import Parameter
from fnssl_tpu_torch.data.scene import save_file
from fnssl_tpu_torch.data.sources import SyntheticSpeechDataset
from fnssl_tpu_torch.data.trajectory import RandomTrajectoryDataset


def make_fnssl_trajectory_dataset(source_dataset=None, *, T: float = 4.79,
                                  fs: int = 16000, num_source: int = 1,
                                  source_state: str = "mobile",
                                  noise_type: str = "spatial_white",
                                  noise_path: str | None = None,
                                  nb_points: int = 50, seed: int = 0
                                  ) -> RandomTrajectoryDataset:
    """FN-SSL stage config (Simu.py:12-64). Pass a LibriSpeechDataset for
    real speech; defaults to the synthetic speech-like source."""
    if source_dataset is None:
        source_dataset = SyntheticSpeechDataset(T, fs, num_source)
    noise = NoiseDataset(T, fs, nmic=2,
                         noise_type=Parameter([noise_type], discrete=True),
                         noise_path=noise_path, c=343.0)
    return RandomTrajectoryDataset(
        sourceDataset=source_dataset,
        num_source=Parameter(num_source),
        source_state=source_state,
        room_sz=Parameter([6, 6, 2.5], [10, 8, 6]),
        T60=Parameter(0.2, 1.3),
        abs_weights=Parameter([0.5] * 6, [1.0] * 6),
        array_setup=dualch_array_setup(),
        array_pos=Parameter([0.1, 0.1, 0.3], [0.9, 0.5, 0.5]),
        noiseDataset=noise,
        SNR=Parameter(-5, 15),
        nb_points=nb_points,
        min_dis=Parameter(0.3, 0.5),
        seed=seed)


def make_ipdnet_trajectory_dataset(source_dataset=None, *, stage: str =
                                   "train", T: float = 4.5,
                                   fs: int = 16000, num_source=(1, 2),
                                   source_state: str = "mobile",
                                   noise_type: str = "spatial_white",
                                   noise_path: str | None = None,
                                   nb_points: int = 50, seed: int | None
                                   = None) -> RandomTrajectoryDataset:
    """IPDnet stage config (IPDnet/Simu.py:11-70): T=4.5 s, 50 trajectory
    points, stage-dependent SNR/T60 (train −5–15 dB / 0.2–1.3 s,
    dev/test 0–15 dB / 0.2–1 s), random 1-or-2 sources, diffuse-capable
    noise, seeds 100/101/102 for train/test/dev. Reference scale: 300k
    train / 4k dev / 4k test.
    """
    snr = Parameter(-5, 15) if stage == "train" else Parameter(0, 15)
    t60 = Parameter(0.2, 1.3) if stage == "train" else Parameter(0.2, 1.0)
    if seed is None:
        seed = {"train": 100, "test": 101, "dev": 102}.get(stage, 0)
    if source_dataset is None:
        source_dataset = SyntheticSpeechDataset(T, fs, max(num_source))
    noise = NoiseDataset(T, fs, nmic=2,
                         noise_type=Parameter([noise_type], discrete=True),
                         noise_path=noise_path, c=343.0)
    return RandomTrajectoryDataset(
        sourceDataset=source_dataset,
        num_source=Parameter(list(num_source), discrete=True),
        source_state=source_state,
        room_sz=Parameter([6, 6, 2.5], [10, 8, 6]),
        T60=t60,
        abs_weights=Parameter([0.5] * 6, [1.0] * 6),
        array_setup=dualch_array_setup(),
        array_pos=Parameter([0.1, 0.1, 0.3], [0.9, 0.5, 0.5]),
        noiseDataset=noise,
        SNR=snr,
        nb_points=nb_points,
        min_dis=Parameter(0.3, 0.5),
        seed=seed)


def generate(out_dir: str, num: int, dataset=None, start_idx: int = 0,
             log_every: int = 0, compact: bool = False):
    """Write ``num`` scenes (the reference's Simu.py main loop).

    ``compact=False`` writes the reference wav + pickled-scene contract
    (FN-SSL/utils.py:138-164, ~8 MB/scene — the pickle keeps the full
    noise/source signals and per-sample trajectories). ``compact=True``
    writes one self-contained npz per scene holding only what training
    consumes — scaled-int16 mic signals plus the per-segment DOA/VAD
    labels the Segmenting transform would produce (Dataset.py:759-837)
    — ~0.3 MB/scene, so reference-scale corpora (IPDnet trains on 300k
    utterances, IPDnet/Simu.py:12-29) fit ordinary disks. Both formats
    are read transparently by FixTrajectoryDataset. Existing files are
    skipped, so an interrupted generation resumes where it stopped.
    """
    from fnssl_tpu_torch.data.fixed import save_compact

    os.makedirs(out_dir, exist_ok=True)
    dataset = dataset or make_fnssl_trajectory_dataset()
    seg = None
    if compact:
        from fnssl_tpu_torch.data.segmenting import Segmenting
        seg = Segmenting()
    for i in range(start_idx, start_idx + num):
        path = os.path.join(out_dir, f"{i:06d}.npz" if compact
                            else f"{i}.wav")
        if os.path.exists(path):
            continue
        scene = dataset.get_random_scene(i)
        mic_signals = scene.simulate()
        if compact:
            save_compact(path, mic_signals.astype(np.float32), scene, seg)
        else:
            save_file(mic_signals.astype(np.float32), scene, path,
                      os.path.join(out_dir, f"{i}.npz"))
        if log_every and (i + 1) % log_every == 0:
            print(f"generated {i + 1 - start_idx}/{num}", flush=True)
    return out_dir
