#!/usr/bin/env python3
"""Times K1 above H = 256 (FN-SSL at hidden_size 512): lstm_wide.cu in turns
with another tree's lstm_fwd.cu, and the hidden-512 train cell.

  python3 /path/to/tools/lstm_wide_cells.py [--parent DIR] [--sweep]
      [--cells] [--out DIR] [--seed N]

Run from the root of a checkout (it imports that checkout's
``fnssl_tpu_torch`` and ``chip_smoke.py``).

``--sweep`` (needs ``--parent DIR``, a tree that holds
``fnssl_tpu_torch/kernels/csrc/lstm_fwd.cu``, e.g. a parent commit unpacked
with ``git archive``): builds DIR's lstm_fwd.cu beside this tree's kernels
and, at each point of SWEEP (T, B, H) x 1 and 2 directions x fp32 and bf16,
holds both against the plain version (``lstm_fwd_plain``, max |kernel -
plain| of ys, hT, cT within chip_smoke's TOL) and times them in turns,
lstm_fwd.cu, lstm_wide.cu, lstm_wide.cu, lstm_fwd.cu (CUDA events, warm,
one launch a direction for lstm_fwd.cu as its wrapper made them), with the
plan this tree's rule gives lstm_wide.cu; fails where lstm_wide.cu measured
slower than lstm_fwd.cu (the rule sends every H above 256 to it).

``--cells``: FN-SSL at FNSSLConfig(hidden_size=512), nb 16 x 4.79 s, fp32
then the bf16 policy, 1 warm + chip_smoke.WIDE_STEPS timed steps each (ms a
step, peak memory), and one traced step each: K1's device ms by kernel, the
card's busy time. A tree from before lstm_wide.cu runs its own kernels: run
this script from each tree's root in turns to compare them.

Writes ``DIR/lstm_wide_cells.json`` (default ``results/lstm_wide_cells``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

# (T, B, H): hidden 512's narrow band in training (nb 16) and at 8 scenes,
# its parity step (nb 1 x 2 s), chip_smoke's V2_CASE, and H 768 /
# 1024 (T cut to 64: the rule does not take T)
SWEEP = [(298, 4096, 512), (298, 2048, 512), (124, 256, 512), (5, 13, 512),
         (64, 4096, 768), (64, 4096, 1024), (5, 13, 1024)]
K1_KERNELS = ("lstm_cluster_kernel", "lstm_wave_kernel", "lstm_wide_kernel",
              "lstm_fwd_kernel")


def parent_library(parent: Path, out: Path) -> ctypes.CDLL:
    """DIR's lstm_fwd.cu, built with this tree's nvcc flags."""
    from fnssl_tpu_torch.kernels import cuda_build

    src = parent / "fnssl_tpu_torch/kernels/csrc/lstm_fwd.cu"
    lib = out / "liblstm_fwd_parent.so"
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                    str(lib), str(src)], check=True, capture_output=True,
                   timeout=600)
    dll = ctypes.CDLL(str(lib))
    dll.lstm_fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                             + [ctypes.c_void_p])
    dll.lstm_fwd.restype = ctypes.c_int
    return dll


def parent_fwd(dll, xg, w, h0, c0, ndir):
    """lstm_fwd.cu over `ndir` stacked directions, one launch each, the
    second walking backwards (as the parent's lstm_fwd_bidir)."""
    ys = torch.empty(xg.shape[:-1] + (w.shape[-2],), dtype=xg.dtype,
                     device=xg.device)
    h_t, c_t = torch.empty_like(h0), torch.empty_like(c0)
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    for d in range(ndir):
        t_steps, batch, four_h = xg.shape[1:]
        err = dll.lstm_fwd(xg[d].data_ptr(), w[d].data_ptr(),
                           h0[d].data_ptr(), c0[d].data_ptr(),
                           ys[d].data_ptr(), h_t[d].data_ptr(),
                           c_t[d].data_ptr(), t_steps, batch, four_h // 4, d,
                           int(xg.dtype == torch.bfloat16), xg.device.index,
                           stream)
        if err:
            raise RuntimeError(f"parent lstm_fwd.cu failed: {err}")
    return ys, h_t, c_t


def sweep(cs, dll, device):
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    rows, slower = [], []
    for t, b, h in SWEEP:
        for ndir in (1, 2):
            for dtype in ("float32", "bfloat16"):
                tdt = getattr(torch, dtype)
                args = cs.lstm_inputs(t, b, h, tdt, device, 3, ndir=ndir)
                wide = ((lambda: L.lstm_fwd_bidir(*args)) if ndir == 2 else
                        (lambda: L.lstm_fwd(*(a[0] for a in args))))
                old = lambda: parent_fwd(dll, *args, ndir)  # noqa: E731
                want = L.lstm_fwd_bidir_plain(*args) if ndir == 2 else tuple(
                    o[None] for o in L.lstm_fwd_plain(*(a[0] for a in args)))
                errs = {}
                for name, fn in (("wide", wide), ("parent", old)):
                    got = fn()
                    if ndir == 1 and name == "wide":
                        got = tuple(o[None] for o in got)
                    errs[name] = {k: cs.max_abs_diff(g, w) for k, g, w in
                                  zip(("ys", "hT", "cT"), got, want)}
                    for k, e in errs[name].items():
                        if not e <= cs.TOL[dtype][k]:
                            raise AssertionError(
                                f"{name} at {(t, b, h, ndir)} {dtype}: {k} "
                                f"off by {e}")
                del want, got
                iters = 3 if t * b * h * h > 2e10 else 20
                ms = {"parent": [], "wide": []}
                for name in ("parent", "wide", "wide", "parent"):
                    ms[name].append(cs.cuda_ms(wide if name == "wide"
                                               else old, iters))
                row = {"T": t, "B": b, "H": h, "ndir": ndir, "dtype": dtype,
                       "plan": L.wide_plan(h, b, ndir),
                       "route": L.fwd_route(t, b, h, ndir, tdt.itemsize),
                       "wide_ms": ms["wide"], "lstm_fwd_ms": ms["parent"],
                       "max_abs_err": errs,
                       "bound_ms": cs.bound({k: ndir * v for k, v in
                                             cs.bound_terms(t, b, h,
                                                            tdt.itemsize)
                                             .items()})[0]}
                rows.append(row)
                w_ms, p_ms = min(ms["wide"]), min(ms["parent"])
                if row["route"] == "wide" and w_ms > p_ms:
                    slower.append((t, b, h, ndir, dtype))
                cs.log(f"  ({t}, {b}, {h}) ndir {ndir} {dtype}: lstm_wide.cu"
                       f" (R {row['plan']}) " + " ".join(
                           f"{v:.4f}" for v in ms["wide"]) + " ms, "
                       "lstm_fwd.cu " + " ".join(
                           f"{v:.4f}" for v in ms["parent"])
                       + f" ms; bound {row['bound_ms']:.4f}; max |ys - plain|"
                       f" {errs['wide']['ys']:.3g} (lstm_fwd.cu "
                       f"{errs['parent']['ys']:.3g})")
                del args
                torch.cuda.empty_cache()
    if slower:
        raise AssertionError(f"the rule sends to lstm_wide.cu points where it "
                             f"measured slower than lstm_fwd.cu: {slower}")
    return rows


def cells(cs, seed, device):
    out = {}
    for precision in ("fp32", "bf16"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, step, batch = cs.train_setup(seed, device, cs.WIDE_NB,
                                            precision, cs.WIDE_HIDDEN)
        gen = torch.Generator(device=device).manual_seed(seed)
        state, ms, losses = cs.timed_steps(state, step, batch, gen,
                                           cs.WIDE_STEPS)
        prof = cs.profile_step(lambda: step(state, batch, gen))
        k1 = {k: sum(t["ms"] for t in prof["top"] if k in t["kernel"])
              for k in K1_KERNELS}
        out[precision] = {"ms": ms.tolist(), "ms_mean": float(ms.mean()),
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "losses": losses, "busy_ms": prof["busy_ms"],
                          "idle_share": prof["idle_share"],
                          "k1_device_ms": prof["groups_ms"]["K1"]
                          if "K1" in prof["groups_ms"] else None,
                          "k1_by_kernel_ms": k1, "groups_ms":
                          prof["groups_ms"]}
        cs.log(f"  hidden {cs.WIDE_HIDDEN} {precision}: step ms "
               + " ".join(f"{v:.2f}" for v in ms) + f" (mean "
               f"{ms.mean():.2f}); peak "
               f"{out[precision]['peak_bytes'] / 2**30:.2f} GiB; traced: "
               f"busy {prof['busy_ms']:.2f} ms, K1 "
               f"{prof['groups_ms']['K1']:.2f} (" + ", ".join(
                   f"{k} {v:.2f}" for k, v in k1.items() if v) + ")")
        del state, step, batch
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--cells", action="store_true")
    ap.add_argument("--out", default="results/lstm_wide_cells")
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lstm_wide_cells: needs a CUDA device")
    if args.sweep and not args.parent:
        sys.exit("lstm_wide_cells: --sweep needs --parent DIR")
    import chip_smoke as cs
    from fnssl_tpu_torch.kernels import cuda_build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    cs.log(f"{card}; tree {ROOT}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    device = torch.device("cuda", 0)
    cuda_build.build([p.stem for p in sorted(cuda_build.CSRC.glob("*.cu"))])
    report = {"card": card, "tree": str(ROOT)}
    if args.sweep:
        cs.log(f"[sweep] lstm_wide.cu against {args.parent}'s lstm_fwd.cu")
        dll = parent_library(Path(args.parent).resolve(), out.resolve())
        report["sweep"] = sweep(cs, dll, device)
    if args.cells:
        cs.log(f"[cells] FN-SSL hidden {cs.WIDE_HIDDEN}, nb {cs.WIDE_NB}")
        report["cells"] = cells(cs, args.seed, device)
    (out / "lstm_wide_cells.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
