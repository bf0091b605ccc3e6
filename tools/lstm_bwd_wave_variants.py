#!/usr/bin/env python3
"""Times variants of K2's large-batch kernel (``csrc/lstm_bwd_wave.cu``) on
the card against each other and against ``lstm_bwd_cluster.cu``.

  python3 tools/lstm_bwd_wave_variants.py [--variants a,b] [--out DIR]

Run from the root of a checkout on a machine with the card. Every variant
is a text-substituted copy of the package's source, compiled by nvcc with
the package's flags (all at once; the instances that spill are counted),
loaded with ctypes, held against the plain version (1e-4) at a ragged
shape, and timed with CUDA events in turns (the variants in order, then
in reverse) at FN-SSL's narrow band in training (T, B, H) = (298, 4096,
256), in a DP rank's step (298, 2048, 256) and at (298, 4768, 256), one
direction, fp32 and bf16 (dy in bf16; W_hh as each variant takes it).
Writes ``DIR/variants.json`` (default ``results/lstm_bwd_wave``).

The variants, each against ``base`` (the package's source at 4 rows a
thread: 256 threads, two CTAs an SM, W_hh in float32; ``base5``, the same
library at its 5-row tile, with a bfloat16 dy only):
  r8        8 rows a thread (tiles of 32 rows, one CTA an SM);
  r2        2 rows a thread (tiles of 8 rows, three CTAs an SM);
  r5        5 rows a thread with a float32 dy too (tiles of 20, one CTA
            an SM);
  t512      512 threads, a warp 4 unit lanes x 8 row groups (tiles of 32
            rows, one CTA an SM, W_hh read once a step an SM);
  one_bar   the next step's G copied after the whole product (one barrier
            in place of four);
  halves    copied by halves (two barriers);
  pf_l1     W_hh's next 8 rows prefetched into L1 a block ahead of their
            loads;
  w_bf16    a bfloat16 W_hh read and widened in the product loop (the
            wrapper widens it once in the package).
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

BLOCK_END = ("      __syncthreads();  // every read of gate block e done\n"
             "      if (more && warp == 0) stage_gates(s - 1, e);\n    }\n")
PF = '''__device__ __forceinline__ void prefetch_l1(const float* w_hh, int k0,
                                            int u0, int hidden) {
#pragma unroll
  for (int e = 0; e < 2 * kBlock; ++e) {
    const int k = (k0 + e) % (4 * hidden);
    asm volatile("prefetch.global.L1 [%0];\\n" ::"l"(
        w_hh + static_cast<size_t>(k) * hidden + u0));
  }
}

// acc[i][u] +='''
LOOP = "        const int kg = e * hidden + kk;\n"
W_BF16 = '''__device__ __forceinline__ void load_block(float4 (&w)[kBlock],
                                           const __nv_bfloat16* w_hh, int k0,
                                           int u0, int hidden) {
#pragma unroll
  for (int e = 0; e < kBlock; ++e)
    w[e] = widen(__ldg(reinterpret_cast<const uint2*>(
        w_hh + static_cast<size_t>(k0 + e) * hidden + u0)));
}

// W_hh rows'''
BOUNDS = "__launch_bounds__(kThreads, 2)"
ROWS_CHECK = ("rows == kRows ||", "rows == 4 ||")  # callers pass 4


def rows(n, ctas):
    """n rows a thread, `ctas` CTAs an SM as the registers are budgeted."""
    return [("constexpr int kRows = 4;", f"constexpr int kRows = {n};"),
            (BOUNDS, f"__launch_bounds__(kThreads, {ctas})"), ROWS_CHECK]


VARIANTS = {
    "base": [],
    "r8": rows(8, 1),
    "r2": rows(2, 3),
    "r5": rows(5, 2),
    "t512": [("constexpr int kThreads = 256;",
              "constexpr int kThreads = 512;"),
             ("const int wcols = hidden / 32;",
              "const int wcols = hidden / 16;"),
             ("const int u0 = ((warp % wcols) * 8 + lane % 8) * kUnits;",
              "const int u0 = ((warp % wcols) * 4 + lane % 4) * kUnits;"),
             ("const int rg = (warp / wcols) * 4 + lane / 8;",
              "const int rg = (warp / wcols) * 8 + lane / 4;"),
             (BOUNDS, "__launch_bounds__(kThreads, 1)")],
    "one_bar": [(BLOCK_END, "    }\n    __syncthreads();\n"
                 "    if (more && warp == 0)\n"
                 "      for (int e = 0; e < 4; ++e) stage_gates(s - 1, e);"
                 "\n")],
    "halves": [(BLOCK_END, "      if (e & 1) {\n        __syncthreads();\n"
                "        if (more && warp == 0) {\n"
                "          stage_gates(s - 1, e - 1);\n"
                "          stage_gates(s - 1, e);\n        }\n      }\n"
                "    }\n")],
    "pf_l1": [("// acc[i][u] +=", PF),
              (LOOP, LOOP + "        prefetch_l1(w_hh, kg + 2 * kBlock, u0,"
                            " hidden);\n")],
    "w_bf16": [("// W_hh rows", W_BF16),
               ("                     const float* __restrict__ w_hh,\n",
                "                     const T_in* __restrict__ w_hh,\n"),
               ("a.g, a.cs, static_cast<const float*>(a.w_hh), a.c0,",
                "a.g, a.cs, static_cast<const T_in*>(a.w_hh), a.c0,")],
}
SHAPES = [(298, 4096, 256), (298, 2048, 256), (298, 4768, 256)]


def build(names, out):
    src = (cuda_build.CSRC / "lstm_bwd_wave.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, spills = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        spills[name] = sum(1 for line in log.splitlines()
                           if "spill stores" in line
                           and not line.strip().startswith("0 bytes"))
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.lstm_bwd_wave.argtypes = L._ARGTYPES["lstm_bwd_wave"]
        lib.lstm_bwd_wave.restype = ctypes.c_int
        libs[name] = lib
    return libs, spills


def inputs(device, t, b, h, dtype, seed=8):
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=gen, device=device)
                * scale).to(dt)

    return (randn(t, b, 4 * h), randn(4 * h, h, scale=h ** -0.5, dt=dtype),
            randn(b, h, scale=0.5), randn(t, b, h, dt=dtype),
            randn(b, h, scale=0.5), randn(b, h, scale=0.5))


def runner(lib, name, args, device, rows=4):
    """One launch of variant `name` on `args` (one direction) at `rows` rows
    a thread, its W_hh widened to float32 but for w_bf16."""
    g, w, c0, dys, dh_t, dc_t = args
    if name != "w_bf16":
        w = w.float().contiguous()
    t, b, four_h = g.shape
    cs = torch.empty(dys.shape, device=device)
    dh0, dc0 = torch.empty_like(c0), torch.empty_like(c0)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch():
        err = lib.lstm_bwd_wave(
            g.data_ptr(), cs.data_ptr(), w.data_ptr(), c0.data_ptr(),
            dys.data_ptr(), dh_t.data_ptr(), dc_t.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), t, b, four_h // 4, 1, 0,
            int(dys.dtype == torch.bfloat16), rows, device.index, stream)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")
        return g, dh0, dc0
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default="results/lstm_bwd_wave")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lstm_bwd_wave_variants: needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    names = args.variants.split(",")
    libs, spills = build(names, out)
    print(f"instances that spill: {spills}", flush=True)
    for name, lib in libs.items():          # held against the plain version
        for dtype in (torch.float32, torch.bfloat16):
            a = inputs(device, 7, 37, 256, dtype, 3)
            want = L.lstm_bwd_plain(a[0].clone(), *a[1:])
            got = runner(lib, name, (a[0].clone(),) + a[1:], device)()
            torch.cuda.synchronize()
            err = max((x - y).abs().max().item() for x, y in zip(got, want))
            if not err <= 1e-4:
                raise AssertionError(f"{name} {dtype}: max|diff| {err}")
    rows = []
    for t, b, h in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            a = inputs(device, t, b, h, dtype)
            ms = {}
            runs = {n: runner(libs[n], n, a, device) for n in names}
            if dtype == torch.bfloat16 and "base" in libs:
                runs["base5"] = runner(libs["base"], "base", a, device, 5)
            runs["cluster"] = lambda: L.lstm_bwd(*a, route="cluster")
            order = list(runs)[:-1]
            for name in order + order[::-1] + ["cluster"]:
                ms.setdefault(name, []).append(cuda_ms(runs[name]))
            row = {"T": t, "B": b, "H": h, "dtype": str(dtype), "ms": ms,
                   "card": card}
            rows.append(row)
            print(json.dumps({k: v if k != "ms" else {
                n: [round(x, 3) for x in m] for n, m in v.items()}
                for k, v in row.items()}), flush=True)
            del a
    (out / "variants.json").write_text(json.dumps(
        {"card": card, "spills": spills, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
