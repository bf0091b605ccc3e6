"""Frame-level voice-activity detection for the host data path.

The webrtcvad slot (C++ GMM VAD, FN-SSL/Dataset.py:221-233). Two native
detectors behind one dispatch:

  * ``gmm_frame_vad`` — a faithful float reimplementation of the webrtc
    VAD architecture (sim/native/gmm_vad.cpp): 6 sub-band log2-energy
    features, per-band 2+2-component noise/speech GMMs, minimum-
    statistics noise tracking, hangover, aggressiveness modes 0-3. The
    default for silence cleaning, like the reference.
  * ``frame_vad`` — the simpler energy-floor detector (10 ms frame
    energies vs a 5th-percentile noise floor + aggressiveness margin),
    kept as the deterministic fallback and for the energy-VAD use cases.

The reference only uses VAD to *clean silences* from LibriSpeech
utterances with a 66%-kept fallback ladder; ``clean_silences`` applies
that ladder over whichever detector is available.

Port of ``fnssl_tpu/data/vad.py``, the same numpy code.
"""
from __future__ import annotations

import numpy as np

# per-aggressiveness (energy percentile threshold offset dB)
_AGGRESSIVENESS_DB = {3: 9.0, 2: 6.0, 1: 3.0, 0: 1.5}


def gmm_frame_vad(signal: np.ndarray, fs: int,
                  aggressiveness: int = 3) -> np.ndarray:
    """webrtcvad-class GMM VAD (native). Per-sample 0/1 mask; raises
    RuntimeError when the native library cannot be built."""
    from fnssl_tpu_torch.sim import native

    out = native.gmm_vad_native(
        np.asarray(signal, np.float32), fs, aggressiveness)
    return out.astype(np.asarray(signal).dtype)


def frame_vad(signal: np.ndarray, fs: int, aggressiveness: int = 3,
              frame_ms: float = 10.0) -> np.ndarray:
    """Per-sample binary VAD from 10 ms frame energies.

    A frame is speech when its log energy exceeds the noise floor
    (5th percentile) by an aggressiveness-dependent margin.
    Returns a 0/1 array the length of ``signal``.
    """
    flen = int(frame_ms * 1e-3 * fs)
    n = len(signal) // flen
    if n == 0:
        return np.zeros_like(signal)
    margin = _AGGRESSIVENESS_DB.get(aggressiveness, 6.0)
    from fnssl_tpu_torch.sim import native
    if native.vad_available():
        out = np.zeros_like(signal)
        out[: n * flen] = native.frame_vad_native(
            signal[: n * flen], flen, margin).astype(signal.dtype)
        return out
    frames = signal[: n * flen].reshape(n, flen)
    energy_db = 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-12)
    floor = np.percentile(energy_db, 5.0)
    active = energy_db > floor + margin
    out = np.zeros_like(signal)
    out[: n * flen] = np.repeat(active.astype(signal.dtype), flen)
    return out


def clean_silences(s: np.ndarray, fs: int, min_keep: float = 0.66,
                   method: str = "auto") -> tuple[np.ndarray, np.ndarray]:
    """Silence cleaning with the reference's aggressiveness ladder
    (Dataset.py:305-311): start strict, relax until ≥66% of samples kept.
    ``method``: 'auto' (GMM VAD when the native lib builds, else energy),
    'gmm', or 'energy'. Returns (cleaned signal, vad mask)."""
    detect = frame_vad
    if method != "energy":
        from fnssl_tpu_torch.sim import native
        if native.gmm_vad_available():
            detect = gmm_frame_vad
        elif method == "gmm":
            raise RuntimeError("native GMM VAD unavailable")
    for aggressiveness in (3, 2, 1):
        vad = detect(s, fs, aggressiveness)
        cleaned = s * vad
        if np.count_nonzero(cleaned) >= len(s) * min_keep:
            break
    return cleaned, vad
