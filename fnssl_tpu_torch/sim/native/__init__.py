"""ctypes loader for the port's C++/OpenMP host engines (port of
``fnssl_tpu/sim/native/__init__.py``).

The sources beside this file (``ism.cpp``, ``vad.cpp``, ``gmm_vad.cpp``)
are the port's own copies. Each is built at its first use with the flags
of the JAX package's Makefile, by the first compiler of ``$CXX``, ``g++``
and ``c++`` that builds it (a ``g++`` may lack OpenMP: one first on PATH
fails ``-fopenmp`` with "cannot read spec file 'libgomp.spec'" where the
system's ``c++`` builds), into ``_build/`` beside the
package (listed in ``.gitignore``), under a name that carries the hash of
the source, the flags and the host CPU (``-march=native`` code runs only
on the CPU it was built for). Nothing is built when the module is
imported. When a library cannot be built or loaded, ``*_available()``
says so and callers take the numpy engine. These are host engines of the
data path, not device kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shlex
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall", "-shared")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}
_errors: dict[str, str] = {}


def _host_cpu() -> str:
    """The CPU that ``-march=native`` targets: model name and flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.processor() or platform.machine()


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        (SRC_DIR / f"{name}.cpp").read_bytes() + " ".join(CXX_FLAGS).encode()
        + _host_cpu().encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _build(name: str) -> Path | None:
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    compilers = [shlex.split(os.environ["CXX"])] if os.environ.get("CXX") \
        else []
    errors = []
    for cxx in compilers + [["g++"], ["c++"]]:
        try:
            subprocess.run([*cxx, *CXX_FLAGS, "-o", str(tmp),
                            str(SRC_DIR / f"{name}.cpp")],
                           check=True, capture_output=True, text=True,
                           timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            tmp.unlink(missing_ok=True)
            errors.append(f"{e}\n{getattr(e, 'stderr', '') or ''}".strip())
            continue
        os.replace(tmp, out)          # atomic: concurrent builds agree
        return out
    _errors[name] = "\n".join(errors)
    return None


def _load(name: str, declare) -> ctypes.CDLL | None:
    """The library built from ``<name>.cpp``, or None when it cannot be
    built or loaded (tried once per process)."""
    with _lock:
        if name not in _libs:
            lib = None
            path = _build(name)
            if path is not None:
                try:
                    lib = ctypes.CDLL(str(path))
                    declare(lib)
                except OSError as e:
                    _errors[name] = str(e)
                    lib = None
            _libs[name] = lib
        return _libs[name]


def build_error(name: str) -> str | None:
    """Why the library of ``<name>.cpp`` could not be built or loaded,
    once it was tried; None when it was not tried or it loaded."""
    return _errors.get(name)


def _declare_ism(lib):
    lib.simulate_rir_native.argtypes = [
        np.ctypeslib.ndpointer(np.float64, flags="C"),   # room
        np.ctypeslib.ndpointer(np.float64, flags="C"),   # beta
        np.ctypeslib.ndpointer(np.float64, flags="C"),   # src
        np.ctypeslib.ndpointer(np.float64, flags="C"),   # mic
        np.ctypeslib.ndpointer(np.int32, flags="C"),     # nb_img
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # npts nch nsamp
        ctypes.c_double, ctypes.c_double,                # fs c
        np.ctypeslib.ndpointer(np.float32, flags="C"),   # out
    ]
    lib.simulate_rir_native.restype = None
    lib.ism_num_threads.restype = ctypes.c_int32


def _declare_vad(lib):
    lib.frame_vad_native.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C"),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_double,
        np.ctypeslib.ndpointer(np.float32, flags="C"),
    ]
    lib.frame_vad_native.restype = None


def _declare_gmm(lib):
    lib.gmm_vad_native.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C"),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float32, flags="C"),
    ]
    lib.gmm_vad_native.restype = ctypes.c_int64


def _ism():
    return _load("ism", _declare_ism)


def native_available() -> bool:
    return _ism() is not None


def num_threads() -> int:
    lib = _ism()
    return int(lib.ism_num_threads()) if lib else 0


def simulate_rir_native(room_sz, beta, src_pos, mic_pos, nb_img,
                        tmax: float, fs: float,
                        c: float = 343.0) -> np.ndarray:
    """C++/OpenMP drop-in for sim.ism.simulate_rir (same signature)."""
    lib = _ism()
    if lib is None:
        raise RuntimeError("native ISM library unavailable")
    room = np.ascontiguousarray(room_sz, np.float64)
    beta = np.ascontiguousarray(beta, np.float64)
    src = np.ascontiguousarray(np.atleast_2d(src_pos), np.float64)
    mic = np.ascontiguousarray(np.atleast_2d(mic_pos), np.float64)
    orders = np.ascontiguousarray(
        np.maximum(np.asarray(nb_img, np.int32), 0))
    npts, nch = src.shape[0], mic.shape[0]
    nsamp = int(np.ceil(tmax * fs))
    out = np.zeros((npts, nch, nsamp), np.float32)
    lib.simulate_rir_native(room, beta, src, mic, orders,
                            npts, nch, nsamp, float(fs), float(c), out)
    return out


def vad_available() -> bool:
    return _load("vad", _declare_vad) is not None


def gmm_vad_available() -> bool:
    return _load("gmm_vad", _declare_gmm) is not None


def gmm_vad_native(signal, fs: int, mode: int = 3) -> np.ndarray:
    """webrtcvad-class GMM VAD (C++, ``gmm_vad.cpp``).

    Per-sample 0/1 mask. mode 0..3 = webrtcvad set_mode aggressiveness.
    """
    lib = _load("gmm_vad", _declare_gmm)
    if lib is None:
        raise RuntimeError("native GMM VAD library unavailable")
    sig = np.ascontiguousarray(signal, np.float32)
    out = np.zeros(len(sig), np.float32)
    rc = lib.gmm_vad_native(sig, len(sig), int(fs), int(mode), out)
    if rc < 0:
        raise ValueError(f"gmm_vad_native: bad fs={fs} or mode={mode}")
    return out


def frame_vad_native(signal, frame_len: int, margin_db: float):
    """C++ drop-in for the energy-ladder frame VAD core."""
    lib = _load("vad", _declare_vad)
    if lib is None:
        raise RuntimeError("native VAD library unavailable")
    sig = np.ascontiguousarray(signal, np.float32)
    out = np.zeros(len(sig), np.float32)
    lib.frame_vad_native(sig, len(sig), frame_len, float(margin_db), out)
    return out
