#!/usr/bin/env python3
"""Times the FN-SSL and IPDnet train cells and K1/K2 at H = 128, the LSTM
recurrences' full-band and IPDnet narrow-band shapes.

  python3 /path/to/tools/h128_cells.py [--out DIR] [--seed N]

Run from the root of a checkout (it imports that checkout's
``fnssl_tpu_torch`` and ``chip_smoke.py``, so a tree from before the H =
128 tiles runs its own kernels and rule: put both trees' runs in one call
to compare them). On the card it runs chip_smoke's phase 8 (FN-SSL's train
cell, nb=16 x 4.79 s, fp32 then the bf16 policy: 1 warm and 5 timed steps
each, ms a step, peak memory, exact launches); times K1 and K2 a launch, on
the kernel the tree's rule gives each, and cuDNN's forward (nn.LSTM, TF32
off) at FN-SSL's full band in training (256, 4768, 128, both directions),
IPDnet's narrow band (280, 4096, 128) and VariableIPDnet's (280, 12288,
128), fp32 and bf16, the card's time from a trace (chip_smoke.device_ms);
traces one FN-SSL train step of each precision (the card's busy time, K1's
and K2's kernels in it); and runs chip_smoke's phase 15 (IPDnet's fixed-
and variable-array train cells, fp32 and bf16, with the tree's launch
contracts). Writes ``DIR/h128_cells.json`` (default
``results/h128_cells``).
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

K1_KERNELS = ("lstm_cluster_kernel", "lstm_wave_kernel")
K2_KERNELS = ("lstm_bwd_cluster_kernel", "lstm_bwd_wave_kernel")
SHAPES = [(256, 4768, 128, 2), (280, 4096, 128, 1), (280, 12288, 128, 1)]


def launches(cs, device):
    """K1 and K2 a launch at SHAPES, each on the kernel the tree's rule
    gives it."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    out = []
    for t, b, h, ndir in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            row = {"T": t, "B": b, "H": h, "ndir": ndir, "dtype": str(dtype),
                   "k1_route": L.fwd_route(t, b, h, ndir, dtype.itemsize),
                   "k2_route": L.bwd_route(t, b, h, ndir, dtype.itemsize)}
            k1, k2 = ((L.lstm_fwd_bidir, L.lstm_bwd_bidir) if ndir == 2
                      else (L.lstm_fwd, L.lstm_bwd))
            args = cs.lstm_inputs(t, b, h, dtype, device, 13, ndir=ndir)
            if ndir == 1:
                args = tuple(a[0] for a in args)
            row["k1_ms"] = cs.device_ms(lambda: k1(*args), 3)
            del args
            args = cs.bwd_inputs((ndir,), t, b, h, dtype, device, 8)
            if ndir == 1:
                args = tuple(a[0] for a in args)
            row["k2_ms"] = cs.device_ms(lambda: k2(*args), 3)
            del args
            # cuDNN's forward (nn.LSTM, TF32 off), the yardstick
            ref = torch.nn.LSTM(h, h, batch_first=True,
                                bidirectional=ndir == 2).to(device, dtype)
            x = torch.randn(b, t, h, device=device, dtype=dtype)
            with torch.no_grad(), cs.library_flags(False):
                row["cudnn_fwd_ms"] = cs.device_ms(lambda: ref(x), 3)
            del ref, x
            out.append(row)
            cs.log(f"  ({t}, {b}, {h}, ndir {ndir}) {dtype}: K1 "
                   f"{row['k1_route']} {row['k1_ms']:.3f} ms, K2 "
                   f"{row['k2_route']} {row['k2_ms']:.3f} ms a launch; "
                   f"cuDNN forward (TF32 off) {row['cudnn_fwd_ms']:.3f}")
    return out


def traced_step(cs, seed, device):
    """One traced FN-SSL train step of each precision after a warm one: the
    card's busy time and K1's and K2's kernels in it."""
    out = {}
    for precision in ("fp32", "bf16"):
        state, step, batch = cs.train_setup(seed, device, cs.TRAIN_NB,
                                            precision)
        gen = torch.Generator(device=device).manual_seed(seed)
        state, _ = step(state, batch, gen)
        (state, _), events, _ = cs.guarded_trace(step, state, batch, gen)
        by = {k: sum(e.time_range.end - e.time_range.start for e in events
                     if k in e.name) / 1e3 for k in K1_KERNELS + K2_KERNELS}
        out[precision] = {
            "busy_ms": sum(e.time_range.end - e.time_range.start
                           for e in events) / 1e3,
            "device_ms": by,
            "k1_ms": sum(by[k] for k in K1_KERNELS),
            "k2_ms": sum(by[k] for k in K2_KERNELS)}
        cs.log(f"  {precision} step: busy {out[precision]['busy_ms']:.2f} ms,"
               f" K1 {out[precision]['k1_ms']:.2f} ms, K2 "
               f"{out[precision]['k2_ms']:.2f} ms (" + ", ".join(
                   f"{k} {v:.2f}" for k, v in by.items()) + ")")
        del state, step, batch
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/h128_cells")
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("h128_cells: needs a CUDA device")
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
    train, train_launches = cs.phase_train(args.seed, device)
    cs.log("[launches] K1 and K2 a launch at H = 128")
    per_launch = launches(cs, device)
    cs.log("[step] one traced FN-SSL train step of each precision")
    per_step = traced_step(cs, args.seed, device)
    cs.log("[ipdnet train] IPDnet's fixed- and variable-array train cells")
    ipd, ipd_launches = cs.phase_ipdnet_train(args.seed, device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "h128_cells.json").write_text(json.dumps(
        {"card": card, "tree": str(ROOT), "train": train,
         "train_launches": train_launches, "launches": per_launch,
         "step": per_step, "ipdnet_train": ipd,
         "ipdnet_launches": ipd_launches}, indent=1))


if __name__ == "__main__":
    main()
