"""Pre-generated dataset reader + batching (wav + pickled-scene npz,
or the compact per-scene npz written by ``generate(compact=True)``).

Parity: FN-SSL/Dataset.py:491-545 ``FixTrajectoryDataset``. Returns
(mic_signals, {'doa', 'vad_sources'}) at the segment rate when a
Segmenting transform is attached (compact scenes store the segmented
labels directly, so transforms are skipped for them).

Port of ``fnssl_tpu/data/fixed.py``, the same numpy code.
"""
from __future__ import annotations

import os

import numpy as np

from fnssl_tpu_torch.data.scene import AcousticScene, load_file


def save_compact(path: str, mic_signals: np.ndarray, scene,
                 segmenting) -> None:
    """One self-contained npz per scene: scaled-int16 mic signals +
    per-segment DOA and window-mean VAD (what training actually
    consumes; the int16 quantization sits ~90 dB under the per-file
    peak, far below the simulated noise floor)."""
    mic_signals, scene = segmenting(mic_signals, scene)
    scale = max(float(np.abs(mic_signals).max()), 1e-9) / 0.95
    i16 = np.rint(np.clip(mic_signals / scale * 32767.0,
                          -32767, 32767)).astype(np.int16)
    # (nseg, K, ns) window VAD → window mean, kept 3-D so the collate
    # contract (mean over the window axis) is unchanged
    vad_w = scene.mic_vad_sources.mean(axis=1, keepdims=True)
    np.savez(path, compact=np.int8(1), mic_i16=i16,
             scale=np.float32(scale),
             doa_w=scene.DOAw.astype(np.float32),
             vad_w=vad_w.astype(np.float32),
             fs=np.int32(scene.fs))


def _numeric_key(path: str):
    stem = os.path.splitext(os.path.basename(path))[0]
    try:
        return (0, int(stem), path)
    except ValueError:
        return (1, 0, path)


class FixTrajectoryDataset:
    def __init__(self, data_dir: str, dataset_sz: int | None = None,
                 transforms=None, return_acoustic_scene: bool = False):
        self.transforms = transforms
        files = os.listdir(data_dir)
        self.data_paths = sorted(
            (os.path.join(data_dir, f) for f in files
             if f.endswith(".wav")), key=_numeric_key)
        self.compact = not self.data_paths
        if self.compact:   # a dir of compact npz scenes (no wavs)
            self.data_paths = sorted(
                (os.path.join(data_dir, f) for f in files
                 if f.endswith(".npz")), key=_numeric_key)
        self.dataset_sz = (len(self.data_paths) if dataset_sz is None
                           else dataset_sz)
        self.return_acoustic_scene = return_acoustic_scene

    def __len__(self):
        return self.dataset_sz

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            idx = idx[0]  # per-item seeds are irrelevant for fixed data
        if idx < 0:
            idx = len(self) + idx
        sig_path = self.data_paths[idx]
        if self.compact:
            if self.return_acoustic_scene:
                raise ValueError("compact scenes store only training "
                                 "labels, not the full AcousticScene")
            z = np.load(sig_path)
            mic = z["mic_i16"].astype(np.float32) * (
                float(z["scale"]) / 32767.0)
            return mic, {"doa": z["doa_w"].astype(np.float32),
                         "vad_sources": z["vad_w"]}
        acous_path = sig_path[:-4] + ".npz"
        mic_signals, scene = load_file(AcousticScene.empty(), sig_path,
                                       acous_path)
        if self.transforms is not None:
            for t in self.transforms:
                mic_signals, scene = t(mic_signals, scene)
        if self.return_acoustic_scene:
            return mic_signals, scene
        return mic_signals.astype(np.float32), {
            "doa": scene.DOAw.astype(np.float32),
            "vad_sources": scene.mic_vad_sources}


def collate_segmented(items, pool: int = 12, pad_tracks: int | None = None):
    """Stack dataset items into the jit batch contract
    {'mic_sig', 'doa', 'vad'} — VAD windows reduced to their window mean
    (the reference's ``vad_batch.mean(axis=2)`` at main.py:242).

    ``pad_tracks`` zero-pads the source axis to a fixed track count (the
    reference's fixed-shape gt padding, IPDnet/Dataset.py:518-534) so
    1-source data trains multi-track PIT models.
    """
    def pad(a):
        # per-item pad (before stacking): batches may mix source counts
        # when num_source is sampled per scene (IPDnet/Dataset.py:518-534
        # pads each item to a fixed track count for exactly this reason)
        if pad_tracks is not None and a.shape[-1] < pad_tracks:
            extra = pad_tracks - a.shape[-1]
            a = np.concatenate(
                [a, np.zeros(a.shape[:-1] + (extra,), a.dtype)], -1)
        return a

    mic = np.stack([x for x, _ in items]).astype(np.float32)
    doa = np.stack([pad(g["doa"]) for _, g in items]).astype(np.float32)
    # (nb, nseg, 2, ns); vad windows (nb, nseg, K, ns) → mean over K
    vad = np.stack([pad(g["vad_sources"]) for _, g in items])
    vad = vad.mean(axis=2).astype(np.float32)
    return {"mic_sig": mic, "doa": doa, "vad": vad}
