#!/usr/bin/env python3
"""Times variants of K1's large-batch kernel (``csrc/lstm_wave.cu``) on the
card, and with ``--sweep`` runs chip_smoke.py's sweep of it against
``lstm_cluster.cu``.

  python3 tools/lstm_wave_variants.py [--sweep] [--variants a,b]

Run from the root of a checkout on a machine with the card. Every variant
is compiled by nvcc with the package's flags (all at once; registers and
spills from ``-Xptxas -v`` are printed), loaded with ctypes in place of the
package's library, held against the plain version (1e-4) and timed with
``chip_smoke.device_ms`` (the card's time from a trace) at each tile it
takes, at FN-SSL's narrow band (T, B, H) in training (298, 4096, 256), in
the 16-slot tick (12, 4096, 256) and in a DP rank's step (298, 2048, 256),
and at the H = 128 shapes of FN-SSL's full band (256, 4768, both
directions) and IPDnet's narrow band (280, 4096), fp32 (bf16 too at the
first two). Writes ``results/lstm_wave/variants.json`` and the built files
beside it.

The variants: ``base``, the package's source (rows a thread 32, 16, 8);
``kb2`` and ``kb8``, blocks of 2 or 8 k's of W_hh in registers in place of
4; and ``tf32x3``, the step product on the tensor cores under 3xTF32
(``tools/lstm_wave_tf32x3.cu``: tiles of 16 or 32 rows, W_hh through a ring
of 4 stages of 8 k-rows in shared memory), with ``tf32x3_chunk16`` 2 stages
of 16.

``--sweep`` then runs ``chip_smoke.phase_wave_times`` and
``chip_smoke.phase_wave_sweep`` with the package's own build (the numbers
fwd_route's thresholds come from) and writes ``sweep.json``.

``--clocks`` runs the package's kernel at (298, 4096, 256) fp32 back to
back for a few seconds while ``nvidia-smi`` samples the SM clock, power
and temperature every 100 ms, and prints their medians beside the
kernel's ms and the FMA rate it reached (the 67 TFLOP/s peak assumes the
1.98 GHz boost clock).

``--sass`` disassembles the package's build (``cuobjdump -sass``) and
prints, for each kernel instance, the instruction mix of its product
loop (the backward branch whose body holds the most FFMAs): instances
with H read at run time (``HC`` 0) beside those with H = 256 a
compile-time constant.
"""
import collections
import re
import argparse
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
from fnssl_tpu_torch.kernels import lstm_cuda as L  # noqa: E402

TOOLS = Path(__file__).resolve().parent
KB = "constexpr int kBlock = 4;"
# name: (source, text substitutions, rows a thread (or tile) to time)
VARIANTS = {
    "base": (cuda_build.CSRC / "lstm_wave.cu", [], None),
    "kb2": (cuda_build.CSRC / "lstm_wave.cu",
            [(KB, "constexpr int kBlock = 2;")], None),
    "kb8": (cuda_build.CSRC / "lstm_wave.cu",
            [(KB, "constexpr int kBlock = 8;")], None),
    "tf32x3": (TOOLS / "lstm_wave_tf32x3.cu", [], (32, 16)),
    "tf32x3_chunk16": (TOOLS / "lstm_wave_tf32x3.cu",
                       [("#define WAVE_CHUNK 8", "#define WAVE_CHUNK 16"),
                        ("#define WAVE_STAGES 4", "#define WAVE_STAGES 2")],
                       (32, 16)),
}
SHAPES = [("train_narrowband", 298, 4096, 256, 1),
          ("slots16_narrowband", 12, 4096, 256, 1),
          ("dp_rank_narrowband", 298, 2048, 256, 1),
          ("train_fullband", 256, 4768, 128, 2),
          ("ipdnet_train_narrowband", 280, 4096, 128, 1)]
DTYPES = {shape: ("float32", "bfloat16") if k < 2 else ("float32",)
          for k, (shape, *_) in enumerate(SHAPES)}
OUT = ROOT / "results/lstm_wave"


def build(name):
    path, subs, _ = VARIANTS[name]
    src = path.read_text()
    for old, new in subs:
        if old not in src:
            raise ValueError(f"{name}: {old!r} is not in {path.name}")
        src = src.replace(old, new)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    done = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if done.returncode:
        raise RuntimeError(f"{name}: {done.stderr}")
    return name, so, [line.split("Used")[1].strip() if "Used" in line
                      else line.strip()
                      for line in done.stderr.splitlines()
                      if "registers" in line or "spill" in line]


def load(so):
    lib = ctypes.CDLL(str(so))
    lib.lstm_wave.argtypes = L._ARGTYPES["lstm_wave"]
    lib.lstm_wave.restype = ctypes.c_int
    lib.lstm_wave_error_string.argtypes = [ctypes.c_int]
    lib.lstm_wave_error_string.restype = ctypes.c_char_p
    return lib


def variants(names, device):
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(build, names))
    package = L._library
    rows = []
    try:
        for name, so, regs in built:
            cs.log(f"{name}: " + "; ".join(regs))
            lib = load(so)
            L._library = (lambda n, lib=lib: lib if n == "lstm_wave"
                          else package(n))
            plans = VARIANTS[name][2]
            for shape, t, b, h, ndir in SHAPES:
                for dtype in DTYPES[shape]:
                    tdt = getattr(torch, dtype)
                    args = cs.lstm_inputs(t, b, h, tdt, device, 7, ndir=2)
                    fn, plain = L.lstm_fwd_bidir, L.lstm_fwd_bidir_plain
                    if ndir == 1:
                        args = tuple(a[0] for a in args)
                        fn, plain = L.lstm_fwd, L.lstm_fwd_plain
                    want = plain(*args)
                    iters = 5 if t > 100 else 20
                    for plan in plans or [r for r in L.WAVE_ROWS if
                                          L.wave_fits(h, tdt.itemsize, r)]:
                        got = fn(*args, route="wave", plan=plan)
                        torch.cuda.synchronize()
                        err = [(g.float() - w.float()).abs().max().item()
                               for g, w in zip(got, want)]
                        if not (max(err[1:]) <= 1e-4 and err[0] <= (
                                1e-4 if dtype == "float32" else 2e-2)):
                            raise AssertionError(f"{name} {shape} {plan}: "
                                                 f"max|diff| {err}")
                        ms = cs.device_ms(lambda: fn(*args, route="wave",
                                                     plan=plan), iters)
                        rows.append({"variant": name, "shape": shape,
                                     "dtype": dtype, "T": t, "B": b, "H": h,
                                     "ndir": ndir, "plan": plan, "ms": ms,
                                     "max_abs_err": max(err)})
                        cs.log(f"  {name:14s} {shape:24s} {dtype:8s} plan "
                               f"{plan}: {ms:.4f} ms (max|diff| "
                               f"{max(err):.1e})")
                    del args, want
    finally:
        L._library = package
    (OUT / "variants.json").write_text(json.dumps(rows, indent=1))


def clocks(device, seconds=6.0):
    """The SM clock, power and temperature while lstm_wave.cu runs at
    FN-SSL's training narrow band back to back."""
    t, b, h = 298, 4096, 256
    args = tuple(a[0] for a in cs.lstm_inputs(t, b, h, torch.float32,
                                              device, 7, ndir=1))
    ms = cs.cuda_ms(lambda: L.lstm_fwd(*args, route="wave"), 5)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(int(seconds * 1e3 / ms)):
            L.lstm_fwd(*args, route="wave")
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    rows = [[float(v) for v in line.split(",")] for line in out.splitlines()
            if line.count(",") == 2]
    med = [sorted(col)[len(col) // 2] for col in zip(*rows)]
    tflops = 2 * b * h * 4 * h * t / ms / 1e9
    cs.log(f"  lstm_wave.cu (298, 4096, 256) fp32 back to back: {ms:.4f} ms "
           f"a launch, {tflops:.1f} TFLOP/s; {len(rows)} samples, median SM "
           f"clock {med[0]:.0f} MHz, power {med[1]:.1f} W, "
           f"{med[2]:.0f} C; the FMA peak at that clock "
           f"{67 * med[0] / 1980:.1f} TFLOP/s")
    return {"ms": ms, "tflops": tflops, "samples": rows}


def sass_mix():
    """The product loop's instruction mix of every instance of the
    package's lstm_wave.cu (its k loop: 2 x 4 k's a turn)."""
    dump = subprocess.run(
        [str(Path(cuda_build.nvcc_path()).with_name("cuobjdump")), "-sass",
         str(cuda_build.library_path("lstm_wave"))], capture_output=True,
        text=True, check=True).stdout
    rows = []
    for part in dump.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        args = re.search(r"lstm_wave_kernelI(.+?)Li(\d+)ELi(\d+)E", name)
        ins = [(int(m.group(1), 16), m.group(2), line) for line in
               part.splitlines() for m in [re.match(
                   r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?P\d+\s+)?([A-Z0-9_.]+)",
                   line)] if m]
        loops = []
        for off, op, line in ins:
            jump = re.search(r"BRA (0x[0-9a-f]+)", line)
            if op.startswith("BRA") and jump and int(jump.group(1), 16) < off:
                loops.append(collections.Counter(
                    o.split(".")[0] for a, o, _ in ins
                    if int(jump.group(1), 16) <= a <= off))
        # the innermost loop that holds the product's FFMAs: the shortest
        # with at least 0.9 of the most FFMAs any loop holds (the step's
        # loop adds the cell update's)
        most = max(mix["FFMA"] for mix in loops)
        best = min((mix for mix in loops if mix["FFMA"] >= 0.9 * most),
                   key=lambda mix: sum(mix.values()))
        row = {"dtype": "float32" if args.group(1) == "f" else "bfloat16",
               "rows": int(args.group(2)), "HC": int(args.group(3)),
               "instructions": sum(best.values()), "FFMA": best["FFMA"],
               "mix": dict(best.most_common(8))}
        rows.append(row)
        cs.log(f"  {row['dtype']:8s} R={row['rows']:2d} HC={row['HC']:3d}: "
               f"product loop {row['instructions']} instructions, "
               f"{row['FFMA']} FFMA ({row['FFMA'] / row['instructions']:.1%})"
               f"; {row['mix']}")
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lstm_wave_variants: needs a CUDA device")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cs.log(smi.stdout.strip())
    cuda_build.build(["lstm_wave", "lstm_cluster"])
    names = [n for n in args.variants.split(",") if n]
    if names:
        variants(names, device)
    if args.sass:
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "sass.json").write_text(json.dumps(sass_mix()))
    if args.clocks:
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "clocks.json").write_text(json.dumps(clocks(device)))
    if args.sweep:
        OUT.mkdir(parents=True, exist_ok=True)
        times = cs.phase_wave_times(device)
        sweep = cs.phase_wave_sweep(device)
        (OUT / "sweep.json").write_text(json.dumps(
            {"times": times, "sweep": sweep}, indent=1))


if __name__ == "__main__":
    main()
