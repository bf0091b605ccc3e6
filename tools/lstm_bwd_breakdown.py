#!/usr/bin/env python3
"""Where a launch of K2 spends its time on the card, for both of its
sources: fnssl_tpu_torch/kernels/csrc/lstm_bwd_cluster.cu and
lstm_bwd_wave.cu.

  python3 tools/lstm_bwd_breakdown.py [--source lstm_bwd_cluster|lstm_bwd_wave]

Builds each source and copies of it with one part cut out, into
fnssl_tpu_torch/_build/variants/, and times them all on the same inputs
at the two training shapes of FN-SSL at nb=16, fp32, with CUDA events, in
turns (base, variants, variants reversed, base), each at the plan of its
rule. lstm_bwd_wave.cu runs its H = 128 kernel at the full band and its
other kernel at the narrow band; a shape times the cuts of the kernel it
runs. The cuts:
  no_product — the per-step product dgates @ W_hh (both sources);
  no_replay  — the replay of c (both sources);
  no_remote  — lstm_bwd_cluster.cu: every CTA stores its dgates N times
               into its own buffer instead of once into each CTA of the
               cluster (the same bytes on the same mbarrier, no
               distributed shared memory);
  dg_one_row — lstm_bwd_cluster.cu: the product reads one row of dgates
               for every row of the tile (1/Bt of its dgates loads from
               shared memory, the same FMAs);
  loads_cached — lstm_bwd_cluster.cu: every walk step loads the operands
               of the same time step, which stay in cache (no HBM latency
               for the loads issued a step ahead);
  dg_row0    — lstm_bwd_wave.cu: the product reads the thread's first
               row of dgates for each of its rows (one shared-memory load
               a block instead of R, the same FMAs);
  w_in_l1    — lstm_bwd_wave.cu (both kernels): every block of the product
               reads the same four rows of W_hh, which stay in L1 (no L2
               traffic, the same loads);
  no_w_loads — lstm_bwd_wave.cu at H = 128: the product loads no W_hh
               (each thread's first block used throughout).
The variants compute wrong gradients: they only time what is left. Prints
one JSON line per source and shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from fnssl_tpu_torch.kernels import cuda_build, lstm_cuda  # noqa: E402

# (name, T, B, H, ndir): one train step's recurrences at nb=16
SHAPES = [("train_fullband", 256, 16 * 298, 128, 2),
          ("train_narrowband", 298, 16 * 256, 256, 1)]
# (old, new) by cut; lstm_bwd_wave.cu's are also by the kernel they cut:
# "h128" (its H = 128 kernel), "other" (the other widths') or "both"
CUTS = {
    "lstm_bwd_cluster": {
        "no_product": ("for (int uu = 0; uu < KL; ++uu) {",
                       "for (int uu = 0; uu < 0; ++uu) {"),
        "no_replay": ("for (int s0 = 0; s0 < t_steps; s0 += kRing) {",
                      "for (int s0 = 0; s0 < 0; s0 += kRing) {"),
        "no_remote": ("store_async4(map_rank(dst, p), d, map_rank(bar, p));",
                      "store_async4(map_rank(dst, rank), d, "
                      "map_rank(bar, rank));"),
        "dg_one_row": ("const float4 v = dg[r * hidden + u];",
                       "const float4 v = dg[u];"),
        "loads_cached": ("const int t = backward ? t_steps - 1 - s : s;\n"
                         "    const int t_prev = backward ? t + 1 : t - 1;",
                         "const int t = 1 + 0 * s;\n"
                         "    const int t_prev = 1;"),
    },
    "lstm_bwd_wave": {
        "no_product": ("for (int kk = 0; kk < hidden; kk += 2 * kBlock) {",
                       "for (int kk = 0; kk < 0; kk += 2 * kBlock) {"),
        "no_replay": ("for (int s = 0; s < t_steps; ++s) {\n"
                      "    const int t = time_of(s);",
                      "for (int s = 0; s < 0; ++s) {\n"
                      "    const int t = time_of(s);"),
        "dg_row0": ("for (int i = 0; i < R; ++i) {\n    const float4 d4 =\n"
                    "        *reinterpret_cast<const float4*>(dgrow + i * "
                    "row_stride + k0);",
                    "for (int i = 0; i < R; ++i) {\n    const float4 d4 =\n"
                    "        *reinterpret_cast<const float4*>(dgrow + k0);"),
        "w_in_l1": ("w_hh + static_cast<size_t>(k0 + e) * hidden + u0",
                    "w_hh + static_cast<size_t>(e) * hidden + u0"),
        "no_product_h128": ("for (int kg = 0; kg < four_h; kg += 2 * kBlock)",
                            "for (int kg = 0; kg < 0; kg += 2 * kBlock)"),
        "no_replay_h128": ("for (int s = 0; s < t_steps; ++s) {\n    const "
                           "float* gt",
                           "for (int s = 0; s < 0; ++s) {\n    const "
                           "float* gt"),
        "dg_row0_h128": ("for (int i = 0; i < N; ++i) {\n    const float4 "
                         "d4 =\n        *reinterpret_cast<const float4*>("
                         "dgrow + i * row_stride + k0);",
                         "for (int i = 0; i < N; ++i) {\n    const float4 "
                         "d4 =\n        *reinterpret_cast<const float4*>("
                         "dgrow + k0);"),
        "no_w_loads_h128": ("    load_block(w1, w_hh, kg + kBlock, u0, 128);"
                            "\n    fma_rows<N>(acc, w0, dgrow, kg, stride);"
                            "\n    load_block(w0, w_hh, kg + 2 * kBlock < "
                            "four_h ? kg + 2 * kBlock : 0, u0,\n"
                            "               128);\n",
                            "    fma_rows<N>(acc, w0, dgrow, kg, stride);\n"),
    },
}


def cuts_at(source: str, hidden: int) -> list[str]:
    """The cuts of `source` that touch the kernel it runs at this H."""
    if source != "lstm_bwd_wave":
        return list(CUTS[source])
    return [n for n in CUTS[source] if n == "w_in_l1"
            or n.endswith("_h128") == (hidden == 128)]


def build_variants(source: str) -> dict[str, ctypes.CDLL]:
    src = (cuda_build.CSRC / f"{source}.cu").read_text()
    out = cuda_build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new) in {"base": ("", ""), **CUTS[source]}.items():
        if old and src.count(old) != 1:
            raise RuntimeError(f"{name}: {source}.cu no longer has {old!r}")
        path = out / f"{source}_{name}.cu"
        path.write_text(src.replace(old, new) if old else src)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
             str(out / f"lib{source}_{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {source} {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{source}_{name}.so"))
        fn = getattr(lib, source)
        fn.argtypes = lstm_cuda._ARGTYPES[source]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", choices=list(CUTS), action="append",
                    help="the sources to break down (default: both)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lstm_bwd_breakdown: no CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    card = card.strip().splitlines()[0]
    for source in args.source or list(CUTS):
        libs = build_variants(source)
        for name, t_steps, batch, hidden, ndir in SHAPES:
            gen = torch.Generator(device=device).manual_seed(0)

            def randn(*shape):
                return torch.randn(ndir, *shape, generator=gen,
                                   device=device)

            g = randn(t_steps, batch, 4 * hidden)
            w_hh = randn(4 * hidden, hidden) / hidden ** 0.5
            c0, dh_t, dc_t = (randn(batch, hidden) for _ in range(3))
            dys = randn(t_steps, batch, hidden)
            cs = torch.empty_like(dys)
            dh0, dc0 = torch.empty_like(c0), torch.empty_like(c0)
            stream = torch.cuda.current_stream(device).cuda_stream
            plan = (lstm_cuda.bwd_cluster_plan(hidden, 4)
                    if source == "lstm_bwd_cluster" else
                    (lstm_cuda.bwd_wave_plan(hidden, 4, batch, ndir),))

            def launch(lib):
                err = getattr(lib, source)(
                    g.data_ptr(), cs.data_ptr(), w_hh.data_ptr(),
                    c0.data_ptr(), dys.data_ptr(), dh_t.data_ptr(),
                    dc_t.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
                    t_steps, batch, hidden, ndir, 0, 0, *plan,
                    device.index, stream)
                if err:
                    raise RuntimeError(f"{source} launch failed ({err})")

            def ms(lib, iters=3):
                launch(lib)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    launch(lib)
                end.record()
                torch.cuda.synchronize()
                return start.elapsed_time(end) / iters

            names = ["base"] + cuts_at(source, hidden)
            order = names + names[::-1]
            times = {k: [] for k in names}
            for k in order:
                times[k].append(ms(libs[k]))
            print(json.dumps({"source": source, "shape": name, "T": t_steps,
                              "B": batch, "H": hidden, "ndir": ndir,
                              "plan": plan, "card": card, "ms": times}),
                  flush=True)
            del g, w_hh, c0, dh_t, dc_t, dys, cs, dh0, dc0


if __name__ == "__main__":
    main()
