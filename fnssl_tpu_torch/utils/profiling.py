"""Profiling: a torch.profiler trace and per-function timings (port of
``fnssl_tpu/utils/profiling.py``).

``trace`` records host and CUDA activity and writes a Chrome/Perfetto
trace (open it in https://ui.perfetto.dev or chrome://tracing);
``time_fn`` synchronises the card before reading the clock, since a CUDA
call returns before the card has run it.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block: ``with
    trace('runs/x/profile'): ...`` writes ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn, *args, iters: int = 10, warmup: int = 1) -> dict:
    """Steady-state wall time of ``fn(*args)``, the card synchronised
    after the warm-up and after the timed calls.

    Returns {'mean_s', 'per_iter_ms', 'iters'}.
    """
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "per_iter_ms": dt * 1000.0, "iters": iters}


def summarize(fn, *args, name: str = "fn", iters: int = 10) -> dict:
    """Wall time and the call's floating-point operations in one report.
    The operations are ``torch.utils.flop_counter``'s count of one call
    (matrix products and convolutions; the JAX package takes XLA's cost
    analysis, and neither counts a custom kernel's work)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    flops = float(counter.get_total_flops())
    timing = time_fn(fn, *args, iters=iters)
    out = {"name": name, **timing, "flops": flops}
    if flops > 0 and timing["mean_s"] > 0:
        out["tflops_per_s"] = flops / timing["mean_s"] / 1e12
    return out
