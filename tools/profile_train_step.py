#!/usr/bin/env python3
"""Where one FN-SSL train step spends the card's time: a torch.profiler
trace of the reference cell (nb=16 x 4.79 s, FNSSLConfig(), Adam 1e-3,
dropout on), after one warm step.

  python3 tools/profile_train_step.py [--precision fp32|bf16] [--seed N]

Prints the step's wall time, the card's busy time (the union of kernel
intervals; the rest of the wall time is its idle share) and the kernels
that took the most time, grouped by name, as JSON lines.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from fnssl_tpu_torch.models.fnssl import FNSSL  # noqa: E402
from fnssl_tpu_torch.train import step as S  # noqa: E402
from fnssl_tpu_torch.train import tasks as TK  # noqa: E402


def busy_ms(events) -> float:
    """Length of the union of the device intervals (ms)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total / 1e3                      # the profiler's unit is µs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--precision", default="fp32", choices=("fp32", "bf16"))
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_train_step: no CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    model = FNSSL(device=device,
                  generator=torch.Generator().manual_seed(args.seed))
    tx = S.make_optimizer("adam", 1e-3, 0.8988, 1)
    state = S.init_train_state(model, tx)
    step = S.make_train_step(TK.make_fnssl_task(
        precision=args.precision, device=device).loss_fn, tx)
    batch = {k: torch.as_tensor(v, device=device) for k, v in
             TK.synthetic_fnssl_batch(nb=16, t_s=4.79,
                                      seed=args.seed).items()}
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state, _ = step(state, batch, gen)                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(kernels)
    print(json.dumps({"card": card.strip().splitlines()[0],
                      "precision": args.precision, "loss": float(loss),
                      "wall_ms": wall_ms, "device_busy_ms": busy,
                      "idle_share": 1.0 - busy / wall_ms,
                      "kernel_events": len(kernels)}), flush=True)
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(
            (e.time_range.end - e.time_range.start) / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:args.top]
    for name, ms in top:
        print(json.dumps({"kernel": name[:120], "calls": len(ms),
                          "ms": sum(ms), "share_of_busy": sum(ms) / busy}),
              flush=True)


if __name__ == "__main__":
    main()
