#!/usr/bin/env python3
"""Times the Mamba block's scan chain on the card, and with ``--cells`` the
IPDnet2 paths that run it.

  python3 tools/ssm_chain_times.py [--cells] [--out DIR] [--seed N]

Run from the root of a checkout (it imports that checkout's
``fnssl_tpu_torch`` and ``chip_smoke.py``). The chain is what a Mamba block
computes between the silu'd conv output x (B, L, d_inner) and y = the scan
+ D·x: the x_proj and dt_proj products, the softplus, the scan, with the
block's parameters at IPDnet2's width (d_model 96, d_inner 192, d_state
16). A tree whose scan takes the (exp(Δ·A), Δ·x·B) tensors (one from
before the fused scan, the yardstick of PERF.md §5: run this file from
its root) runs ``models.mamba._ssm_inputs`` and ``SSMScan`` over them; a
tree with the fused selective scan runs ``models.mamba.selective_scan``. At every scan
shape of ``chip_smoke.py`` (its SSM_SHAPES, SSM_SLOT_SHAPES,
SSM_DP_SHAPES, SSM_FP_SHAPES) it reads, from the card's own trace
(``chip_smoke.device_ms``): the forward without autograd (serve), the
forward with autograd and forward + backward (train), fp32; and the
device memory the forward with autograd leaves allocated (what autograd
saves) and the peak of forward + backward above the inputs. Then
``chip_smoke.phase_ssm_times`` at the same shapes (the kernels alone).

``--cells`` adds chip_smoke's phase 20 (IPDnet2's train cell, fp32 and
bf16, and its forward cell, with a profile), phase 18's served chunk
steps and phase 24's 16-slot ticks of IPDnet2. Writes
``DIR/ssm_chain_times.json`` (default ``results/ssm_chain``).
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


def chain(mamba_mod, p):
    """The chain as this tree computes it: (x, h0) -> (y, h_last)."""
    if hasattr(mamba_mod, "selective_scan"):
        return lambda x, h0: mamba_mod.selective_scan(p, x, h0)

    def old(x, h0):
        da, dbx, c = mamba_mod._ssm_inputs(p, x)
        y, h = mamba_mod.ssm_scan(da, dbx, c, h0)
        return y + p.D * x, h
    return old


def chain_rows(cs, device, seed):
    import fnssl_tpu_torch.models.mamba as M

    p = M.Mamba(M.MambaConfig(96), device=device,
                generator=torch.Generator().manual_seed(seed))
    fn = chain(M, p)
    shapes = (cs.SSM_SHAPES + cs.SSM_SLOT_SHAPES + cs.SSM_DP_SHAPES
              + cs.SSM_FP_SHAPES)
    rows = []
    for name, b, t, d in shapes:
        g = torch.Generator(device=device).manual_seed(seed + b + t)
        x = torch.randn(b, t, d, device=device, generator=g)
        h0 = torch.randn(b, d, 16, device=device, generator=g) * 0.5
        dy = torch.randn(b, t, d, device=device, generator=g)
        xg = x.clone().requires_grad_()

        def fwd_bwd():
            y, h = fn(xg, h0)
            torch.autograd.backward((y, h), (dy, torch.ones_like(h)))
            p.zero_grad(set_to_none=True)
            xg.grad = None

        with torch.no_grad():
            serve = cs.device_ms(lambda: fn(x, h0), 20)
        fwd = cs.device_ms(lambda: fn(xg, h0), 10)
        both = cs.device_ms(fwd_bwd, 10)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        y, h = fn(xg, h0)
        torch.cuda.synchronize()
        saved = torch.cuda.memory_allocated() - base
        del y, h
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        row = {"shape": name, "B": b, "L": t, "d": d,
               "fwd_nograd_ms": serve, "fwd_ms": fwd, "fwd_bwd_ms": both,
               "bwd_ms": both - fwd, "saved_bytes": saved,
               "peak_bytes": peak}
        rows.append(row)
        cs.log(f"  chain {name:18s} B={b:3d} L={t:3d}: fwd (no grad) "
               f"{serve:.4f} ms, fwd {fwd:.4f}, bwd {both - fwd:.4f}; "
               f"saved {saved / 2**20:.1f} MiB, peak {peak / 2**20:.1f} MiB")
        del x, xg, h0, dy
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", action="store_true")
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--out", default="results/ssm_chain")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ssm_chain_times: needs a CUDA device")
    import chip_smoke as cs
    from fnssl_tpu_torch.kernels import cuda_build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    cs.log(card)
    reports = cuda_build.build(["ssm_scan"])
    cs.log(reports["ssm_scan"])
    device = torch.device("cuda", 0)
    report = {"card": card, "torch": torch.__version__,
              "chain": chain_rows(cs, device, args.seed)}
    report["kernels"] = cs.phase_ssm_times(
        device, cs.SSM_SHAPES + cs.SSM_SLOT_SHAPES + cs.SSM_DP_SHAPES
        + cs.SSM_FP_SHAPES)
    if args.cells:
        report["train"], _ = cs.phase_ipdnet2_train(args.seed, device)
        _, _, report["serve"] = cs.phase_serve(args.seed, device, "ipdnet2")
        report["slots"], _ = cs.phase_slots(args.seed, device, "ipdnet2")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "ssm_chain_times.json").write_text(json.dumps(report, indent=1,
                                                         default=str))
    cs.log(f"wrote {out / 'ssm_chain_times.json'}")


if __name__ == "__main__":
    main()
