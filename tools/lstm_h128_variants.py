#!/usr/bin/env python3
"""Times K1's and K2's H = 128 tiles (``csrc/lstm_wave.cu``,
``csrc/lstm_bwd_wave.cu``) on the card, with variants of them, against the
kernels' other tiles and the cluster kernels.

  python3 tools/lstm_h128_variants.py [--variants a,b] [--shapes a,b]
                                      [--out DIR]

Run from the root of a checkout on a machine with the card. Every variant
is a text-substituted copy of the package's source, compiled by nvcc with
the package's flags (all at once; nvcc's register and spill lines of the
H = 128 instances are printed), loaded with ctypes and held against the
plain version (1e-4) at a ragged shape (T 7, B 77, both directions, every
plan); then timed with CUDA events in turns (the runs in order, then in
reverse) at FN-SSL's full band in training (256, 4768, 128, both
directions), IPDnet's narrow band (280, 4096, 128) and VariableIPDnet's
(280, 12288, 128), fp32 and bf16. Writes ``DIR/variants.json`` (default
``results/lstm_h128``).

The runs at each shape: ``fwd`` / ``bwd``, the package's kernels at the
plan of their rule; ``fwd:<plan>`` / ``bwd:<plan>``, a plan forced (a 256-
thread tile of 8 or 16 rows a thread, other H = 128 tiles of K2:
``BWD_TILES``); ``cluster`` / ``bwd_cluster``,
lstm_cluster.cu and lstm_bwd_cluster.cu; and each variant at the plan of
the rule (or its own, ``VARIANT_PLANS``). The variants:
  fwd_pf         K1 with thread 0 prefetching the tile's next xg into L2
                 (one bulk prefetch a step);
  fwd_r24        K1's H = 128 tile of 24 rows, 3 CTAs an SM;
  fwd_carve, bwd_carve  the H = 128 kernel's shared-memory carveout set
                 to what two CTAs need (57% and 70%), the rest left to L1;
  bwd_pf         K2 with thread 0 prefetching the next walk step's G,
                 c_{t-1} and dy_t rows of the tile into L2 (three bulk
                 prefetches a step);
  bwd_bar2       two barriers a step at every R: none between the gate
                 blocks of the product (the kernel has them at R = 5);
  bwd_bar6_all   the gate blocks' barriers at every R (six a step);
  bwd_bar6_aligned  them at R = 5 as __syncthreads, which warps of one
                 CTA reach through different branches (R rows or R - 1):
                 undefined in CUDA, timed for reference only;
The cuts of K2's H = 128 kernel (no W_hh loads, no replay, ...) are in
``tools/lstm_bwd_breakdown.py``.
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

from fnssl_tpu_torch.kernels import cuda_build  # noqa: E402
from fnssl_tpu_torch.kernels import lstm_cuda as L  # noqa: E402

PREFETCH = """__device__ __forceinline__ void prefetch_l2(const void* src,
                                            uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}

"""
FWD_HELPERS = ("// acc[r][g] += h[k0 + e][r] * w[e].g for the kBlock k's of one "
               "block, for\n")
FWD_XG = ("        acc[r][g] = r < valid ? load_f(x + r * four_h + g * hidden)"
          " : 0.0f;\n")
FWD_PF = """    if (j == 0 && s + 1 < t_steps)
      prefetch_l2(xg + (backward ? t - 1 : t + 1) * step_len,
                  static_cast<uint32_t>(valid) * four_h * sizeof(T_in));
"""
BWD_HELPERS = ("// acc[i][u] += dgates[row i][k0 + e] * w[e].u for the first N "
               "of the R rows\n")
BWD_BARRIER = "    __syncthreads();  // the tile's dgates in place\n"
BWD_PF = """    if (threadIdx.x == 0 && s > 0) {  // the next walk step's rows
      const int tn = time_of(s - 1);
      prefetch_l2(g + static_cast<size_t>(tn) * gate_step,
                  static_cast<uint32_t>(valid) * four_h * 4);
      prefetch_l2(dys + static_cast<size_t>(tn) * unit_step,
                  static_cast<uint32_t>(valid) * hidden * sizeof(T_in));
      prefetch_l2(s > 1 ? cs + static_cast<size_t>(time_of(s - 2)) * unit_step
                        : c0,
                  static_cast<uint32_t>(valid) * hidden * 4);
    }
"""
GATE_BARRIER = "if (R == 5 && "
FWD_RAISE = ("          static_cast<int>(smem_bytes128(R)));\n"
             "      if (err != cudaSuccess) return err;\n")
BWD_RAISE = ("          static_cast<int>(smem_bytes128(kRowGroups128 * R)));\n"
             "      if (err != cudaSuccess) return err;\n")


def carve(percent):
    """The H = 128 kernel's shared memory carveout set to `percent` of the
    SM's (the rest is L1): what two CTAs an SM need, not the most."""
    return (f"      err = cudaFuncSetAttribute(kernel, "
            f"cudaFuncAttributePreferredSharedMemoryCarveout, {percent});\n"
            "      if (err != cudaSuccess) return err;\n")


VARIANTS = {
    "fwd_pf": ("lstm_wave", [(FWD_HELPERS, PREFETCH + FWD_HELPERS),
                             (FWD_XG, FWD_XG + FWD_PF)]),
    "fwd_r24": ("lstm_wave", [
        ("constexpr int kRows128 = 37;", "constexpr int kRows128 = 24;"),
        ("__launch_bounds__(kThreads128, 2)",
         "__launch_bounds__(kThreads128, 3)")]),
    "fwd_carve": ("lstm_wave", [(FWD_RAISE, FWD_RAISE + carve(57))]),
    "bwd_carve": ("lstm_bwd_wave", [(BWD_RAISE, BWD_RAISE + carve(70))]),
    "bwd_pf": ("lstm_bwd_wave", [(BWD_HELPERS, PREFETCH + BWD_HELPERS),
                                 (BWD_BARRIER, BWD_BARRIER + BWD_PF)]),
    "bwd_bar2": ("lstm_bwd_wave", [(GATE_BARRIER, "if (false && ")]),
    "bwd_bar6_all": ("lstm_bwd_wave", [(GATE_BARRIER, "if (")]),
    "bwd_bar6_aligned": ("lstm_bwd_wave", [
        ('asm volatile("barrier.sync 0;\\n" ::: "memory");',
         "__syncthreads();")]),
}
# the plan a variant runs at, by shape (else its kernel's rule's)
VARIANT_PLANS = {"fwd_r24": dict.fromkeys(("fullband", "ipdnet",
                                           "varipdnet"), 24)}
# K2's tiles forced at each shape beside the rule's
BWD_TILES = {"fullband": (40, 32), "ipdnet": (32, 24),
             "varipdnet": (32, 12)}
SHAPES = {"fullband": (256, 4768, 128, 2), "ipdnet": (280, 4096, 128, 1),
          "varipdnet": (280, 12288, 128, 1)}


def substituted(name):
    """The source text of variant `name`."""
    source, subs = VARIANTS[name]
    text = (cuda_build.CSRC / f"{source}.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        text = text.replace(old, new)
    return text


def build(names, out):
    procs = {}
    for name in names:
        source = VARIANTS[name][0]
        text = substituted(name)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        source = VARIANTS[name][0]
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        fn = getattr(lib, source)
        fn.argtypes = L._ARGTYPES[source]
        fn.restype = ctypes.c_int
        libs[name] = (source, lib)
    return libs


def h128_report(log):
    """nvcc's lines for the H = 128 instances: registers, spills."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "h128" in line
        if keep and ("registers" in line or "spill" in line
                     or "Compiling" in line):
            lines.append(line.strip())
    return lines


def fwd_inputs(device, t, b, h, ndir, dtype, seed=8):
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(ndir, *shape, generator=gen, device=device)
                * scale).to(dt)

    return (randn(t, b, 4 * h, dt=dtype),
            randn(h, 4 * h, scale=h ** -0.5, dt=dtype),
            randn(b, h, scale=0.5), randn(b, h, scale=0.5))


def bwd_inputs(device, t, b, h, ndir, dtype, seed=9):
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(ndir, *shape, generator=gen, device=device)
                * scale).to(dt)

    return (randn(t, b, 4 * h), randn(4 * h, h, scale=h ** -0.5, dt=dtype),
            randn(b, h, scale=0.5), randn(t, b, h, dt=dtype),
            randn(b, h, scale=0.5), randn(b, h, scale=0.5))


def squeeze(args, ndir):
    return args if ndir == 2 else tuple(a[0] for a in args)


def fwd_call(args, ndir, **kw):
    fn = L.lstm_fwd_bidir if ndir == 2 else L.lstm_fwd
    return lambda: fn(*squeeze(args, ndir), **kw)


def bwd_call(args, ndir, **kw):
    fn = L.lstm_bwd_bidir if ndir == 2 else L.lstm_bwd
    return lambda: fn(*squeeze(args, ndir), **kw)


def variant_call(source, lib, args, ndir, plan):
    """One launch of a variant library on the package's inputs."""
    device = args[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    if source == "lstm_wave":
        xg, w, h0, c0 = args
        t, b, four_h = xg.shape[1:]
        outs = (torch.empty(xg.shape[:3] + (four_h // 4,), dtype=xg.dtype,
                            device=device), torch.empty_like(h0),
                torch.empty_like(h0))

        def launch():
            err = lib.lstm_wave(
                xg.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
                t, b, four_h // 4, ndir, 0, int(xg.dtype == torch.bfloat16),
                plan, device.index, stream)
            if err:
                raise RuntimeError(f"launch failed ({err})")
            return tuple(o if ndir == 2 else o[0] for o in outs)
        return launch
    g, w, c0, dys, dh_t, dc_t = args
    t, b, four_h = g.shape[1:]
    w = w.float().contiguous()
    cs = torch.empty(dys.shape, device=device)
    dh0, dc0 = torch.empty_like(c0), torch.empty_like(c0)

    def launch():
        err = lib.lstm_bwd_wave(
            g.data_ptr(), cs.data_ptr(), w.data_ptr(), c0.data_ptr(),
            dys.data_ptr(), dh_t.data_ptr(), dc_t.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), t, b, four_h // 4, ndir, 0,
            int(dys.dtype == torch.bfloat16), plan, device.index, stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return tuple(o if ndir == 2 else o[0] for o in (g, dh0, dc0))
    return launch


def cuda_ms(fn, iters=3):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want):
    torch.cuda.synchronize()
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(got, want))


def check(device, libs):
    """Every H = 128 plan of the package's kernels and every variant against
    the plain versions at T 7, B 77, both directions, fp32 and bf16."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        a = fwd_inputs(device, 7, 77, 128, 2, dtype, 3)
        want = L.lstm_fwd_bidir_plain(*a)
        runs = {f"fwd:{p}": fwd_call(a, 2, route="wave", plan=p)
                for p in L.WAVE128_ROWS}
        runs.update({n: variant_call(s, lib, a, 2, VARIANT_PLANS.get(
            n, {}).get("fullband", L.WAVE128_ROWS[0]))
            for n, (s, lib) in libs.items() if s == "lstm_wave"})
        for name, fn in runs.items():
            err = max_err(fn(), want)
            if not err <= tol:
                raise AssertionError(f"{name} {dtype}: max|diff| {err}")
        bwd = [n for n, (s, _) in libs.items() if s == "lstm_bwd_wave"]
        for tile in L.BWD_WAVE128_TILES:
            a = bwd_inputs(device, 7, 77, 128, 2, dtype, tile)
            want = L.lstm_bwd_bidir_plain(a[0].clone(), *a[1:])
            fns = {f"bwd:{tile}": lambda: L.lstm_bwd_bidir(
                a[0].clone(), *a[1:], route="wave", plan=tile)}
            for n in bwd:
                fns[n] = lambda lib=libs[n][1]: variant_call(
                    "lstm_bwd_wave", lib, (a[0].clone(),) + a[1:], 2, tile)()
            for name, fn in fns.items():
                err = max_err(fn(), want)
                worst = max(worst, err)
                if not err <= 1e-4:
                    raise AssertionError(f"{name} {dtype}: max|diff| {err}")
    return worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--out", default="results/lstm_h128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lstm_h128_variants: needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    reports = cuda_build.build(["lstm_wave", "lstm_bwd_wave",
                                "lstm_cluster", "lstm_bwd_cluster"])
    for name in ("lstm_wave", "lstm_bwd_wave"):
        print(f"{name}: " + "\n  ".join(h128_report(reports[name])),
              flush=True)
    names = [n for n in args.variants.split(",") if n]
    libs = build(names, out)
    print(f"held against the plain versions: worst K2 "
          f"{check(device, libs):.2e}", flush=True)
    rows = []
    for shape in args.shapes.split(","):
        t, b, h, ndir = SHAPES[shape]
        for dtype in (torch.float32, torch.bfloat16):
            item = dtype.itemsize
            a = fwd_inputs(device, t, b, h, ndir, dtype)
            runs = {"fwd": fwd_call(a, ndir, route="wave"),
                    "cluster": fwd_call(a, ndir, route="cluster")}
            for p in (16, 8):
                runs[f"fwd:{p}"] = fwd_call(a, ndir, route="wave", plan=p)
            for n, (s, lib) in libs.items():
                if s == "lstm_wave":
                    runs[n] = variant_call(s, lib, a, ndir, VARIANT_PLANS.get(
                        n, {}).get(shape, L.wave_plan(h, item, b, ndir)))
            ms = timed(runs)
            del a
            a = bwd_inputs(device, t, b, h, ndir, dtype)
            runs = {"bwd": bwd_call(a, ndir, route="wave"),
                    "bwd_cluster": bwd_call(a, ndir, route="cluster")}
            for tile in BWD_TILES[shape]:
                runs[f"bwd:{tile}"] = bwd_call(a, ndir, route="wave",
                                               plan=tile)
            for n, (s, lib) in libs.items():
                if s == "lstm_bwd_wave":
                    runs[n] = variant_call(s, lib, a, ndir, VARIANT_PLANS.get(
                        n, {}).get(shape, L.bwd_wave_plan(h, item, b, ndir)))
            ms.update(timed(runs))
            del a
            row = {"T": t, "B": b, "H": h, "ndir": ndir, "dtype": str(dtype),
                   "fwd_plan": L.wave_plan(h, item, b, ndir),
                   "bwd_plan": L.bwd_wave_plan(h, item, b, ndir),
                   "fwd_route": L.fwd_route(t, b, h, ndir, item),
                   "bwd_route": L.bwd_route(t, b, h, ndir, item),
                   "ms": ms, "card": card}
            rows.append(row)
            print(json.dumps({k: v if k != "ms" else {
                n: [round(x, 3) for x in m] for n, m in v.items()}
                for k, v in row.items()}), flush=True)
    (out / "variants.json").write_text(json.dumps(
        {"card": card, "rows": rows}, indent=1))


def timed(runs):
    """Each run's ms in turns: in order, then in reverse."""
    order = list(runs)
    ms = {}
    for name in order + order[::-1]:
        ms.setdefault(name, []).append(cuda_ms(runs[name]))
    return ms


if __name__ == "__main__":
    main()
