#!/usr/bin/env python3
"""Times the FN-SSL train cell and K2, the LSTM backward recurrence, at its
large-batch shapes.

  python3 /path/to/tools/k2_cells.py [--out DIR] [--seed N]

Run from the root of a checkout (it imports that checkout's
``fnssl_tpu_torch`` and ``chip_smoke.py``, so a tree from before
``lstm_bwd_wave.cu`` runs its own kernels: put both trees' runs in one call
to compare them). On the card it runs chip_smoke's phase 8 (FN-SSL's train
cell, nb=16 x 4.79 s, fp32 then the bf16 policy: 1 warm and 5 timed steps
each, ms a step, peak memory, exact launches); times K2 a launch, on the
kernel the tree's rule gives it, at FN-SSL's narrow band in training (298,
4096, 256) and in a DP rank's step (298, 2048, 256), fp32 and bf16, the
card's time from a trace (chip_smoke.device_ms); and traces one train step
of each precision: the card's busy time and each K2 kernel's time in it.
Writes ``DIR/k2_cells.json`` (default ``results/k2_cells``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

K2_KERNELS = ("lstm_bwd_cluster_kernel", "lstm_bwd_wave_kernel")
SHAPES = [(298, 4096, 256), (298, 2048, 256)]


def k2_launches(cs, device):
    """K2 a launch at SHAPES, the kernel the tree's rule gives each."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    out = []
    for t, b, h in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args = tuple(a[0] for a in cs.bwd_inputs((1,), t, b, h, dtype,
                                                     device, 8))
            ms = cs.device_ms(lambda: L.lstm_bwd(*args), 3)
            out.append({"T": t, "B": b, "H": h, "dtype": str(dtype),
                        "ms": ms})
            cs.log(f"  K2 ({t}, {b}, {h}) {dtype}: {ms:.3f} ms a launch")
            del args
    return out


def k2_step(cs, seed, device):
    """One traced train step of each precision after a warm one: the
    card's busy time and K2's kernels in it."""
    out = {}
    for precision in ("fp32", "bf16"):
        state, step, batch = cs.train_setup(seed, device, cs.TRAIN_NB,
                                            precision)
        gen = torch.Generator(device=device).manual_seed(seed)
        state, _ = step(state, batch, gen)
        (state, _), events, _ = cs.guarded_trace(step, state, batch, gen)
        k2 = {k: sum(e.time_range.end - e.time_range.start for e in events
                     if k in e.name) / 1e3 for k in K2_KERNELS}
        out[precision] = {"busy_ms": sum(e.time_range.end
                                         - e.time_range.start
                                         for e in events) / 1e3,
                          "k2_device_ms": k2,
                          "k2_ms": sum(k2.values())}
        cs.log(f"  {precision} step: busy {out[precision]['busy_ms']:.2f} ms,"
               f" K2 {out[precision]['k2_ms']:.2f} ms (" + ", ".join(
                   f"{k} {v:.2f}" for k, v in k2.items()) + ")")
        del state, step, batch
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/k2_cells")
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k2_cells: needs a CUDA device")
    import chip_smoke as cs
    from fnssl_tpu_torch.kernels import cuda_build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    cs.log(f"{card}; tree {ROOT}")
    device = torch.device("cuda", 0)
    kernels = [p.stem for p in sorted(cuda_build.CSRC.glob("*.cu"))]
    cuda_build.build(kernels)
    cs.log(f"[train] nb={cs.TRAIN_NB} x {cs.TRAIN_T_S} s, fp32 then bf16")
    train, launches = cs.phase_train(args.seed, device)
    cs.log("[k2] a launch at the narrow band's large-batch shapes")
    per_launch = k2_launches(cs, device)
    cs.log("[k2 step] one traced train step of each precision")
    per_step = k2_step(cs, args.seed, device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "k2_cells.json").write_text(json.dumps(
        {"card": card, "tree": str(ROOT), "train": train,
         "train_launches": launches, "k2": per_launch, "k2_step": per_step},
        indent=1))


if __name__ == "__main__":
    main()
