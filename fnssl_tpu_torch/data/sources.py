"""Source-signal datasets: LibriSpeech utterance sampler + a synthetic
speech-like generator for fixture/data-free operation.

Parity: FN-SSL/Dataset.py:203-331 ``LibriSpeechDataset`` — chapter-tree
walk, utterance concatenation to T seconds, silence cleaning with the
aggressiveness fallback ladder, distinct speakers per source. IPDnet's
train-time random overlap mask (IPDnet/Dataset.py:292-299) waits for the
IPDnet port.

Port of ``fnssl_tpu/data/sources.py``, the same numpy code.
"""
from __future__ import annotations

import os

import numpy as np

from fnssl_tpu_torch.data.vad import clean_silences


class LibriSpeechDataset:
    """Random T-second multi-speaker segments from a LibriSpeech tree."""

    def __init__(self, path: str, T: float, fs: int, num_source: int,
                 size: int | None = None, return_vad: bool = False,
                 clean_silence: bool = True):
        self.chapters: list[list[str]] = []
        for root, dirs, files in sorted(os.walk(path)):
            flacs = sorted(f for f in files if f.endswith(".flac"))
            if flacs:
                self.chapters.append(
                    [os.path.join(root, f) for f in flacs])
        if not self.chapters:
            raise FileNotFoundError(f"no .flac files under {path}")
        self.T, self.fs = T, fs
        self.num_source = num_source
        self.return_vad = return_vad
        self.clean_silence = clean_silence
        self.sz = size if size is not None else len(self.chapters)

    def __len__(self):
        return self.sz

    def _speaker_of(self, chapter: list[str]) -> str:
        return os.path.basename(chapter[0]).split("-")[0]

    def _read_segment(self, chapter: list[str],
                      rng: np.random.Generator) -> np.ndarray:
        from fnssl_tpu_torch.utils.audio_io import read_audio

        s = np.array([])
        n = int(rng.integers(0, len(chapter)))
        while s.shape[0] < self.T * self.fs:
            utt, fs = read_audio(chapter[n])
            assert fs == self.fs, f"expected fs={self.fs}, got {fs}"
            s = np.concatenate([s, utt])
            n = (n + 1) % len(chapter)
        s = s[: int(self.T * self.fs)]
        return s - s.mean()

    def get(self, idx: int, rng: np.random.Generator | None = None):
        rng = rng if rng is not None else np.random.default_rng()
        idx = idx % len(self.chapters)
        speakers, raw, cleaned, vads = [], [], [], []
        for s_idx in range(self.num_source):
            if s_idx == 0:
                chapter = self.chapters[idx]
            else:
                while True:
                    chapter = self.chapters[
                        int(rng.integers(0, len(self.chapters)))]
                    if self._speaker_of(chapter) not in speakers:
                        break
            speakers.append(self._speaker_of(chapter))
            s = self._read_segment(chapter, rng)
            c, v = clean_silences(s, self.fs)
            raw.append(s)
            cleaned.append(c)
            vads.append(v)
        sig = np.stack(cleaned if self.clean_silence else raw, axis=1)
        vad = np.stack(vads, axis=1)
        return (sig, vad) if self.return_vad else sig

    def __getitem__(self, idx):
        return self.get(idx)


class SyntheticSpeechDataset:
    """Speech-like amplitude-modulated noise with on/off activity —
    a data-free stand-in honoring the LibriSpeechDataset contract
    (for tests and environments without the corpus)."""

    def __init__(self, T: float, fs: int, num_source: int,
                 size: int = 128, return_vad: bool = True):
        self.T, self.fs = T, fs
        self.num_source = num_source
        self.sz = size
        self.return_vad = return_vad

    def __len__(self):
        return self.sz

    def get(self, idx: int, rng: np.random.Generator | None = None):
        rng = (rng if rng is not None
               else np.random.default_rng(1000003 * (idx + 1)))
        n = int(self.T * self.fs)
        t = np.arange(n) / self.fs
        sigs, vads = [], []
        for _ in range(self.num_source):
            carrier = rng.standard_normal(n)
            # syllabic envelope ~4 Hz with random phase, gated on/off
            env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 6) * t
                                    + rng.uniform(0, 2 * np.pi)))
            gate_len = int(0.3 * self.fs)
            ngate = n // gate_len + 1
            gates = (rng.random(ngate) > 0.3).astype(float)
            if gates.sum() == 0:  # guarantee some speech activity
                gates[int(rng.integers(0, ngate))] = 1.0
            gate = np.repeat(gates, gate_len)[:n]
            sig = carrier * env * gate
            sigs.append(sig - sig.mean())
            vads.append((np.abs(env * gate) > 0.25).astype(np.float64))
        return (np.stack(sigs, 1), np.stack(vads, 1)) if self.return_vad \
            else np.stack(sigs, 1)

    def __getitem__(self, idx):
        return self.get(idx)
