"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, which the kernel's
wrapper loads with ``ctypes``. Nothing is built when a module is
imported: a library is built at its first use, into ``_build/`` beside
the package (listed in ``.gitignore``), under a name that carries the
hash of its source, so an edited source is rebuilt and an unchanged one
is loaded as it is.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class LaunchCounter:
    """Count of a kernel's launches; a wrapper adds one where it launches
    its kernel and nowhere else."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self):
        with self._lock:
            self._n += 1

    def reset(self):
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit's nvcc (set CUDA_HOME)")
    return str(path)


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def start_build(name: str):
    """Start compiling ``csrc/<name>.cu`` unless its library is built;
    returns (running nvcc, temporary output, final path), or None when
    there is nothing to do."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def finish_build(started) -> str:
    """Wait for a build from ``start_build``; returns nvcc's report
    (registers, shared memory, spills). Raises if it failed."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)               # atomic: concurrent builds agree
    return log


def build(names) -> dict[str, str]:
    """Build several kernels at once, one ``nvcc`` per source, all started
    together. Returns each build's report."""
    procs = {n: start_build(n) for n in names}
    return {n: finish_build(p) for n, p in procs.items()}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if need be."""
    finish_build(start_build(name))
    return ctypes.CDLL(str(library_path(name)))
