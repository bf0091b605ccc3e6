"""Audio file IO with a soundfile → scipy.io.wavfile fallback.

The reference hard-depends on python-soundfile (libsndfile) for all audio
IO; this container ships only scipy. WAV float32/PCM covers the framework's
own data contract; FLAC (LibriSpeech) requires soundfile and raises a
clear error when unavailable.

Port of ``fnssl_tpu/utils/audio_io.py``, the same numpy code.
"""
from __future__ import annotations

import numpy as np

try:
    import soundfile as _sf
except ImportError:  # pragma: no cover - environment dependent
    _sf = None


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """Returns (float64 samples (nsample[, nch]), sample rate)."""
    if _sf is not None:
        data, fs = _sf.read(path)
        return data, fs
    if not str(path).lower().endswith(".wav"):
        raise RuntimeError(
            f"soundfile unavailable; cannot read non-wav file {path}")
    from scipy.io import wavfile

    fs, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data / 32768.0
    elif data.dtype == np.int32:
        data = data / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float64) - 128.0) / 128.0
    return data.astype(np.float64), fs


def write_audio(path: str, data: np.ndarray, fs: int):
    if _sf is not None:
        _sf.write(path, data, fs)
        return
    if not str(path).lower().endswith(".wav"):
        raise RuntimeError(
            f"soundfile unavailable; cannot write non-wav file {path}")
    from scipy.io import wavfile

    wavfile.write(path, fs, np.asarray(data, np.float32))
