"""Metric logging, provenance, reproducibility, and NaN guards.

Parity targets (SURVEY.md §2.7, §5.2, §5.5):
  * TensorBoard scalars (MyLogger epoch-stepped val metrics) with a JSONL
    fallback so logs exist even without the torch TB writer;
  * EMA loss display with bias correction (Learner.py:119-120);
  * git/pip provenance dump (utils/git_tools.py:1-15);
  * set_seed (utils.py:85-96) — the host numpy/python RNGs of the data
    pipeline and torch's default generator; the Learner's dropout draws
    from a generator of its own;
  * detect_infnan (utils.py:119-133 — whose torch branch is dead due to a
    'troch' typo; this one works).

Port of ``fnssl_tpu/utils/logging.py``; TensorBoard events are written
only where ``torch.utils.tensorboard`` imports, metrics.jsonl always.
"""
from __future__ import annotations

import json
import os
import random
import subprocess
import time

import numpy as np


class MetricLogger:
    """Scalar logger: TensorBoard events when available + metrics.jsonl."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def log(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "time": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def log_dict(self, metrics: dict, step: int, prefix: str = ""):
        for k, v in metrics.items():
            if np.ndim(v) == 0:
                self.log(prefix + k, float(v), step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class EmaLoss:
    """Bias-corrected EMA for display (Learner.py:119-120)."""

    def __init__(self, beta: float = 0.99):
        self.beta = beta
        self._acc = 0.0
        self._count = 0

    def update(self, value: float) -> float:
        self._acc = self.beta * self._acc + (1 - self.beta) * float(value)
        self._count += 1
        return self._acc / (1 - self.beta ** self._count)


class ProgressLine:
    """Single-line in-place epoch progress (the reference's
    progress-bar slot, Lightning/utils/my_rich_progress_bar.py) —
    batches/s + EMA loss, TTY-only so logs stay clean under nohup/CI."""

    def __init__(self, epoch: int, total: int | None = None):
        import sys
        import time as _t

        self.epoch = epoch
        self.total = total
        self.t0 = _t.monotonic()
        self.n = 0
        self._tty = sys.stderr.isatty()

    @property
    def visible(self) -> bool:
        return self._tty

    def update(self, loss: float):
        import sys
        import time as _t

        self.n += 1
        if not self._tty:
            return
        dt = max(_t.monotonic() - self.t0, 1e-9)
        frac = f"{self.n}/{self.total}" if self.total else f"{self.n}"
        sys.stderr.write(
            f"\repoch {self.epoch} [{frac}] {self.n / dt:5.1f} it/s "
            f"loss {loss:.5f} ")
        sys.stderr.flush()

    def close(self):
        import sys

        if self._tty and self.n:
            sys.stderr.write("\n")
            sys.stderr.flush()


def set_seed(seed: int):
    """Seed the host RNGs: numpy's global, python's and torch's default
    generator."""
    import torch

    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return seed


def detect_infnan(data, label: str = "") -> bool:
    """True (and prints) if data contains inf/NaN. Works for numpy arrays
    and tensors (the reference's torch branch is dead code)."""
    if hasattr(data, "detach"):
        data = data.detach().cpu()
    arr = np.asarray(data)
    bad = not np.isfinite(arr).all()
    if bad:
        n_nan = int(np.isnan(arr).sum())
        n_inf = int(np.isinf(arr).sum())
        print(f"detect_infnan{' ' + label if label else ''}: "
              f"{n_nan} NaN, {n_inf} inf of {arr.size}")
    return bad


def tag_and_log_git_status(out_path: str, note: str = ""):
    """Dump git branch/status/diffstat + pip freeze to ``out_path``
    (utils/git_tools.py equivalent, without mutating the repo with tags)."""
    def run(cmd):
        try:
            return subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=60).stdout
        except Exception as e:  # git/pip may be absent in deploy images
            return f"<{e}>\n"

    with open(out_path, "w") as f:
        f.write(f"note: {note}\ntime: {time.ctime()}\n\n")
        f.write("== git branch ==\n" + run(["git", "branch", "-v"]))
        f.write("\n== git status ==\n" + run(["git", "status", "-s"]))
        f.write("\n== git log -1 ==\n" + run(["git", "log", "-1"]))
        f.write("\n== pip freeze ==\n" + run(["pip", "freeze"]))
