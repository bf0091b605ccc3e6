#!/usr/bin/env python3
"""Times variants of the fused selective scan (``csrc/ssm_scan.cu``) on the
card, each built from a text substitution of the source.

  python3 tools/ssm_scan_variants.py

Run from the root of a checkout on a machine with the card. Every
variant is compiled by nvcc with the package's flags (all at once), loaded
with ctypes in place of the package's library, checked against the first
variant's outputs and timed with ``chip_smoke.device_ms`` (the card's time
from a trace) at IPDnet2's training scan shapes, a mesh rank's and the
16-slot tick's, float32. Writes ``results/ssm_variants/variants.json``
and the built files beside it.

The variants: K4 held to 3 or 2 blocks an SM; the SFU's approximate
exponential for the decay (a diagnostic: the kernels keep expf); blocks
of 64 or 16 channels in place of 32; and K4's 8-step checkpoints in
shared memory (L / 8 x 32 channels x 16 states x 4 B a block: 52 KB at L
201) in place of the scratch in device memory.
"""
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from fnssl_tpu_torch.kernels import cuda_build  # noqa: E402
from fnssl_tpu_torch.kernels import ssm_cuda as S  # noqa: E402

BWD_BOUNDS = "__global__ void __launch_bounds__(kThreads)\nselective_bwd"
BWD_LAUNCH = "  selective_bwd_kernel<T><<<grid, kThreads, 0, s>>>("
VARIANTS = {
    "base": [],
    "bwd_3_blocks": [(BWD_BOUNDS, BWD_BOUNDS.replace(
        "(kThreads)", "(kThreads, 3)"))],
    "bwd_2_blocks": [(BWD_BOUNDS, BWD_BOUNDS.replace(
        "(kThreads)", "(kThreads, 2)"))],
    "fast_exp": [("expf(delta * a[q])", "__expf(delta * a[q])")],
    "blocks_64_channels": [("constexpr int kThreads = 128;",
                            "constexpr int kThreads = 256;")],
    "blocks_16_channels": [("constexpr int kThreads = 128;",
                            "constexpr int kThreads = 64;")],
    "bwd_smem_checkpoints": [
        ("  float* pck = ck + b * nseg * seg_stride + dd * kN + j * kQ;",
         "  extern __shared__ __align__(16) float s_ck[];\n"
         "  float* pck = s_ck + cl * kN + j * kQ;"),
        ("const long long seg_stride = static_cast<long long>(dim) * kN;",
         "const long long seg_stride = kCh * kN;"),
        (BWD_LAUNCH,
         "  const int smem = nseg * kCh * kN * 4;\n"
         "  cudaFuncSetAttribute(selective_bwd_kernel<T>,\n"
         "      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
         + BWD_LAUNCH.replace(", 0, s>>>", ", smem, s>>>"))],
}
SHAPES = [("train_layer0", 256, 201, 192), ("train_layers1_7", 256, 40, 192),
          ("serve_layer0", 16, 5, 192),
          ("fp_rank_layer0", 64, 201, 192), ("slots16_layer0", 256, 5, 192)]
OUT = ROOT / "results/ssm_variants"


def build(name):
    src = (cuda_build.CSRC / "ssm_scan.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise ValueError(f"{name}: {old!r} is not in ssm_scan.cu")
        src = src.replace(old, new)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    done = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if done.returncode:
        raise RuntimeError(f"{name}: {done.stderr}")
    return name, so, [line.split("Used")[1].strip()
                      for line in done.stderr.splitlines()
                      if "registers" in line]


def load(so):
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in S._ARGTYPES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def main():
    if not torch.cuda.is_available():
        sys.exit("ssm_scan_variants: needs a CUDA device")
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(build, VARIANTS))
    device = torch.device("cuda", 0)
    ref, rows = {}, []
    slice_ = S.SLICE
    for name, so, regs in built:
        cs.log(f"{name}: {regs}")
        lib = load(so)
        S._library = lambda lib=lib: lib
        # the partials of d(B), d(C) come one a slice of channels
        S.SLICE = {"blocks_64_channels": 64,
                   "blocks_16_channels": 16}.get(name, slice_)
        for shape, b, t, d in SHAPES:
            x = cs.ssm_inputs(b, t, d, torch.float32, device, 7)
            args = [x[k] for k in cs.SSM_ARGS]
            outs = (list(S.selective_scan_fwd(*args))
                    + list(S.selective_scan_bwd(*args, x["dy"],
                                                x["dh_last"])))
            ref.setdefault(shape, outs)
            diff = max((o - r).abs().max().item()
                       for o, r in zip(outs, ref[shape]))
            k3 = cs.device_ms(lambda: S.selective_scan_fwd(*args), 20)
            k4 = cs.device_ms(lambda: S.selective_scan_bwd(
                *args, x["dy"], x["dh_last"]), 20)
            rows.append({"variant": name, "shape": shape, "k3_ms": k3,
                         "k4_ms": k4, "max_abs_diff_vs_base": diff})
            cs.log(f"  {name:20s} {shape:16s} K3 {k3:.4f} K4 {k4:.4f} ms "
                   f"(vs base {diff:.2e})")
    S.SLICE = slice_
    (OUT / "variants.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
