#!/usr/bin/env python3
"""Where a launch of K2 (fnssl_tpu_torch/kernels/csrc/lstm_bwd.cu) spends
its time, on the card.

  python3 tools/lstm_bwd_breakdown.py

Builds the kernel and three variants of its source, each with one part
cut out (the per-step product dgates @ W_hh; the replay of c; the L2
traffic of W_hh, by reading the same four rows of it, which stay in L1,
for every column of the product), into
fnssl_tpu_torch/_build/variants/, and times all four on the same inputs
at the two training shapes of FN-SSL at nb=16, fp32, with CUDA events,
in turns (base, variants, variants, base). The variants compute wrong
gradients: they only time what is left. Prints one JSON line per shape.
"""
from __future__ import annotations

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
CUTS = {
    "no_product": ("for (int col = col_begin; col < col_begin + k_len;",
                   "for (int col = col_begin; col < col_begin;"),
    "no_replay": ("for (int s = 0; s < t_steps; ++s) {",
                  "for (int s = 0; s < 0; ++s) {"),
    "w_in_l1": ("w_hh + static_cast<size_t>(col) * hidden + j;",
                "w_hh + j;"),
}


def build_variants() -> dict[str, ctypes.CDLL]:
    src = (cuda_build.CSRC / "lstm_bwd.cu").read_text()
    out = cuda_build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new) in {"base": ("", ""), **CUTS}.items():
        if old and src.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        (out / f"{name}.cu").write_text(src.replace(old, new) if old else src)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.lstm_bwd.argtypes = lstm_cuda._ARGTYPES["lstm_bwd"]
        lib.lstm_bwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("lstm_bwd_breakdown: no CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    card = card.strip().splitlines()[0]
    libs = build_variants()
    for name, t_steps, batch, hidden, ndir in SHAPES:
        gen = torch.Generator(device=device).manual_seed(0)

        def randn(*shape):
            return torch.randn(ndir, *shape, generator=gen, device=device)

        g = randn(t_steps, batch, 4 * hidden)
        w_hh = randn(4 * hidden, hidden) / hidden ** 0.5
        c0, dh_t, dc_t = (randn(batch, hidden) for _ in range(3))
        dys = randn(t_steps, batch, hidden)
        cs = torch.empty_like(dys)
        dh0, dc0 = torch.empty_like(c0), torch.empty_like(c0)
        stream = torch.cuda.current_stream(device).cuda_stream

        def launch(lib):
            err = lib.lstm_bwd(
                g.data_ptr(), cs.data_ptr(), w_hh.data_ptr(), c0.data_ptr(),
                dys.data_ptr(), dh_t.data_ptr(), dc_t.data_ptr(),
                dh0.data_ptr(), dc0.data_ptr(), t_steps, batch, hidden, ndir,
                0, 0, device.index, stream)
            if err:
                raise RuntimeError(f"lstm_bwd launch failed ({err})")

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

        order = list(libs) + list(libs)[::-1]
        times = {k: [] for k in libs}
        for k in order:
            times[k].append(ms(libs[k]))
        row = {"shape": name, "T": t_steps, "B": batch, "H": hidden,
               "ndir": ndir, "card": card,
               "ms": times}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
