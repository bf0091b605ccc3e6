#!/usr/bin/env python3
"""Times the FN-SSL paths that run K1's narrow band at large B: the
reference train cell and the 16-slot tick.

  python3 /path/to/tools/k1_cells.py [--out DIR] [--seed N]

Run from the root of a checkout (it imports that checkout's
``fnssl_tpu_torch`` and ``chip_smoke.py``, so a tree from before
``lstm_wave.cu`` runs its own kernels: put both trees' runs in one call to
compare them). On the card it runs chip_smoke's phase 8 (FN-SSL's train
cell, nb=16 x 4.79 s, fp32 then the bf16 policy: 1 warm and 5 timed steps
each, ms a step, peak memory, exact launches) and times a 16-slot FN-SSL
pool (``runtime/slots.SlotBatchedStepper``, FNSSLConfig(), weights from
--seed) as phase 24 does: the ms a tick at tiers 1, 4 and 16 (host clock
around step_slots: features up, the tier's CUDA graph replay, outputs
down; 20 ticks each after the capture), and one traced tier-16 replay: the
card's busy time and K1's kernels in it. Writes ``DIR/k1_cells.json``
(default ``results/k1_cells``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

K1_KERNELS = ("lstm_cluster_kernel", "lstm_wave_kernel")
TICKS = 20


def slot_ticks(cs, seed, device):
    from fnssl_tpu_torch.models.fnssl import FNSSL
    from fnssl_tpu_torch.runtime.export import _resolve
    from fnssl_tpu_torch.runtime.slots import SlotBatchedStepper

    model = FNSSL(device=device,
                  generator=torch.Generator().manual_seed(seed)).eval()
    apply_fn, init_state = _resolve("fnssl", model)
    st = SlotBatchedStepper(apply_fn, model, init_state, slots=16)
    rng = np.random.default_rng(seed)
    out = {}
    for s in st.tier_sizes:
        ids = np.arange(s)
        feats = rng.standard_normal((s, 4, 256, 12)).astype(np.float32)
        reset = np.zeros(s, bool)
        st.step_slots(ids, feats, reset)             # the capture
        ms = []
        for _ in range(TICKS):
            t0 = time.perf_counter()
            st.step_slots(ids, feats, reset)
            ms.append((time.perf_counter() - t0) * 1e3)
        _, events, _ = cs.guarded_trace(st.step_slots, ids, feats, reset)
        k1 = {k: sum(e.time_range.end - e.time_range.start for e in events
                     if k in e.name) / 1e3 for k in K1_KERNELS}
        out[s] = {"ms_mean": float(np.mean(ms)),
                  "ms_p90": float(np.percentile(ms, 90)), "ms": ms,
                  "busy_ms": sum(e.time_range.end - e.time_range.start
                                 for e in events) / 1e3,
                  "k1_device_ms": k1}
        cs.log(f"  tier {s}: {out[s]['ms_mean']:.3f} ms a tick (p90 "
               f"{out[s]['ms_p90']:.3f}); one replay's device time "
               f"{out[s]['busy_ms']:.3f} ms, K1 " + ", ".join(
                   f"{k} {v:.3f}" for k, v in k1.items()))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/k1_cells")
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k1_cells: needs a CUDA device")
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
    cs.log("[slots] a 16-slot FN-SSL pool, tiers 1, 4, 16")
    ticks = slot_ticks(cs, args.seed, device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "k1_cells.json").write_text(json.dumps(
        {"card": card, "tree": str(ROOT), "train": train,
         "train_launches": launches, "slots16": ticks}, indent=1))


if __name__ == "__main__":
    main()
