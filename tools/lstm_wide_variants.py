#!/usr/bin/env python3
"""Times variants of K1 above H = 256 (``csrc/lstm_wide.cu``) on the card.

  python3 tools/lstm_wide_variants.py [--variants a,b] [--shapes a,b]
      [--parent DIR] [--sass] [--clocks]

Run from the root of a checkout on a machine with the card. Every variant
is a text substitution in the package's source, compiled by nvcc with the
package's flags (all at once; registers and spills from ``-Xptxas -v`` are
printed) and loaded with ctypes in place of the package's library. Those
that compute the same function are held against the plain version at (7,
77, H) for H 512 and 1024 (chip_smoke's TOL); the cuts, which leave out a
part of the work to show what it costs, are not. Then every variant is
timed at SHAPES (``--shapes`` picks some by name), each at the tiles
listed there, in rounds: each round times every variant once (CUDA events,
warm), the first variant also last. ``--parent DIR`` adds DIR's
``fnssl_tpu_torch/kernels/csrc/lstm_wide.cu`` (another tree, e.g. an
earlier commit unpacked with ``git archive``) as the variant ``parent``,
timed first, given W_hh^T in the layout its source reads. Writes
``results/lstm_wide/variants.json`` and the built files beside it.

The variants: ``base``, the package's source; ``w1``, W_hh^T as the
model holds it, four 4-byte loads a k from four rows in place of the
package's one 16-byte load (``lstm_cuda.wide_weights``' layout); ``kb2``
and ``kb8``, register blocks of 2 or 8 k's of W_hh in place of 4;
``ldcg``, float32 loads cached in L2 only (``__ldcg``) in place of the
read-only path; the cuts ``cut_w`` (W_hh read from 2 rows, in L1, for
every k: the product without W_hh's L2 traffic) and ``cut_h`` (h read
from one row for every k: the product without its shared-memory loads).

``--sass`` disassembles the package's build (``cuobjdump -sass``) and
prints each instance's product-loop instruction mix.

``--clocks`` runs the package's kernel at (298, 4096, 512) fp32 back to
back for a few seconds while ``nvidia-smi`` samples the SM clock, power
and temperature every 100 ms.
"""
import argparse
import collections
import ctypes
import re
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

SRC = cuda_build.CSRC / "lstm_wide.cu"
W_GATES = SRC.read_text().split("// Four gates (i, f, g, o)")[1].split(
    "template <typename T_in>\n__device__ __forceinline__ void load_block")[0]
# W_hh^T as the model holds it: four 4-byte loads a k, from four rows
W1_GATES = """ of unit u at row k of W_hh^T, from L2
// (w1: the variant's layout, W_hh^T as given).
template <typename T_in>
__device__ __forceinline__ float4 w_gates(const T_in* w, int k, int u,
                                          int hidden) {
  const T_in* p = w + static_cast<size_t>(k) * 4 * hidden + u;
  return make_float4(load_f(p), load_f(p + hidden), load_f(p + 2 * hidden),
                     load_f(p + 3 * hidden));
}

"""
# name: (text substitutions, computes the same function[, W_hh layout])
VARIANTS = {
    "base": ([], True),
    "parent": ([], True),
    "w1": ([(W_GATES, W1_GATES)], True, "t"),
    "kb2": ([("constexpr int kBlock = 4;", "constexpr int kBlock = 2;")],
            True),
    "kb8": ([("constexpr int kBlock = 4;", "constexpr int kBlock = 8;")],
            True),
    "ldcg": ([("float load_f(const float* p) { return __ldg(p); }",
               "float load_f(const float* p) { return __ldcg(p); }")], True),
    "cut_w": ([("static_cast<size_t>(k) * hidden + u",
                "static_cast<size_t>(k & 1) * hidden + u")], False),
    "cut_h": ([("const float* hk = hs + (k0 + e) * pitch;",
                "const float* hk = hs;")], False),
}
# (name, T, B, H, ndir, tiles)
SHAPES = [("train_narrowband", 298, 4096, 512, 1, (32, 16)),
          ("eight_scenes", 298, 2048, 512, 1, (32, 16)),
          ("h768", 64, 4096, 768, 1, (32, 16)),
          ("h1024", 64, 4096, 1024, 1, (16, 8))]
DTYPES = ("float32", "bfloat16")
ROUNDS = 2
OUT = ROOT / "results/lstm_wide"


def build(name, parent=None):
    subs = VARIANTS[name][0]
    src = (SRC if name != "parent" else
           Path(parent) / "fnssl_tpu_torch/kernels/csrc/lstm_wide.cu"
           ).read_text()
    for old, new in subs:
        if old not in src:
            raise ValueError(f"{name}: {old!r} is not in {SRC.name}")
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
    lib.lstm_wide.argtypes = L._ARGTYPES["lstm_wide"]
    lib.lstm_wide.restype = ctypes.c_int
    lib.lstm_wide_error_string.argtypes = [ctypes.c_int]
    lib.lstm_wide_error_string.restype = ctypes.c_char_p
    return lib


def launcher(lib, layout, args, plan):
    """A call of `lib`'s lstm_wide on stacked (ndir, ...) inputs, W_hh^T
    in the variant's layout (made once, outside the call)."""
    xg, w, h0, c0 = args
    ndir, t, b, four_h = xg.shape
    h = four_h // 4
    if layout == "interleaved":
        w = L.wide_weights(w)
    ys = torch.empty(ndir, t, b, h, dtype=xg.dtype, device=xg.device)
    h_t, c_t = torch.empty_like(h0), torch.empty_like(c0)
    stream = torch.cuda.current_stream(xg.device).cuda_stream

    def call():
        err = lib.lstm_wide(xg.data_ptr(), w.data_ptr(), h0.data_ptr(),
                            c0.data_ptr(), ys.data_ptr(), h_t.data_ptr(),
                            c_t.data_ptr(), t, b, h, ndir, 0,
                            int(xg.dtype == torch.bfloat16), plan,
                            xg.device.index, stream)
        if err:
            raise RuntimeError(lib.lstm_wide_error_string(err).decode())
        return ys, h_t, c_t
    return call


def variants(names, device, parent=None):
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(lambda n: build(n, parent), names))
    libs = {}
    for name, so, regs in built:
        cs.log(f"{name}: " + "; ".join(regs))
        libs[name] = load(so)

    def layout(name):
        """W_hh^T's layout a variant reads: the package's, but where the
        variant names another (a parent tree's source: as it reads W)."""
        if name == "parent":
            src = (OUT / "parent.cu").read_text()
            return "interleaved" if "const float4*>(w)" in src else "t"
        return VARIANTS[name][2] if len(VARIANTS[name]) > 2 else \
            "interleaved"

    rows = []
    for name in names:
        if not VARIANTS[name][1]:
            continue
        for h in (512, 1024):
            for dtype in DTYPES:
                args = cs.lstm_inputs(7, 77, h, getattr(torch, dtype),
                                      device, 5, ndir=2)
                want = L.lstm_fwd_bidir_plain(*args)
                for plan in (r for r in L.WIDE_ROWS if L.wide_fits(h, r)):
                    got = launcher(libs[name], layout(name), args, plan)()
                    for k, g, w in zip(("ys", "hT", "cT"), got, want):
                        err = cs.max_abs_diff(g, w)
                        if not err <= cs.TOL[dtype][k]:
                            raise AssertionError(
                                f"{name} H {h} {dtype} plan {plan}: {k} "
                                f"off by {err}")
        cs.log(f"  {name}: every tile at H 512 and 1024 within TOL")
    for shape, t, b, h, ndir, tiles in SHAPES:
        for dtype in DTYPES:
            tdt = getattr(torch, dtype)
            args = cs.lstm_inputs(t, b, h, tdt, device, 7, ndir=ndir)
            bound = cs.bound({k: ndir * v for k, v in cs.bound_terms(
                t, b, h, tdt.itemsize).items()})[0]
            for plan in tiles:
                if not L.wide_fits(h, plan):
                    continue
                calls = {n: launcher(libs[n], layout(n), args, plan)
                         for n in names}
                times = {n: [] for n in names}
                order = [n for _ in range(ROUNDS) for n in names]
                for name in order + names[:1]:
                    times[name].append(cs.cuda_ms(calls[name], 3))
                del calls
                for name in names:
                    rows.append({"variant": name, "shape": shape,
                                 "dtype": dtype, "T": t, "B": b, "H": h,
                                 "ndir": ndir, "plan": plan,
                                 "ms": times[name], "bound_ms": bound})
                cs.log(f"  {shape} {dtype} tile {plan} (bound "
                       f"{bound:.3f} ms): " + "; ".join(
                           f"{n} " + "/".join(f"{v:.3f}" for v in ms)
                           for n, ms in times.items()))
            del args
            torch.cuda.empty_cache()
    (OUT / "variants.json").write_text(json.dumps(rows, indent=1))


def sass_mix():
    """The product loop's instruction mix of every instance of the
    package's lstm_wide.cu: the innermost loop that holds the most
    FFMAs."""
    dump = subprocess.run(
        [str(Path(cuda_build.nvcc_path()).with_name("cuobjdump")), "-sass",
         str(cuda_build.library_path("lstm_wide"))], capture_output=True,
        text=True, check=True).stdout
    rows = []
    for part in dump.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        args = re.search(r"lstm_wide_kernelI(.+?)Li(\d+)ELi(\d+)E", name)
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
        most = max(mix["FFMA"] for mix in loops)
        best = min((mix for mix in loops if mix["FFMA"] >= 0.9 * most),
                   key=lambda mix: sum(mix.values()))
        row = {"dtype": "float32" if args.group(1) == "f" else "bfloat16",
               "rows": int(args.group(2)), "HC": int(args.group(3)),
               "instructions": sum(best.values()), "FFMA": best["FFMA"],
               "mix": dict(best.most_common(10))}
        rows.append(row)
        cs.log(f"  {row['dtype']:8s} R={row['rows']:2d} HC={row['HC']:3d}: "
               f"product loop {row['instructions']} instructions, "
               f"{row['FFMA']} FFMA ({row['FFMA'] / row['instructions']:.1%})"
               f"; {row['mix']}")
    return rows


def clocks(device, seconds=6.0):
    """The SM clock, power and temperature while lstm_wide.cu runs at
    FN-SSL's hidden-512 narrow band back to back."""
    t, b, h = 298, 4096, 512
    args = tuple(a[0] for a in cs.lstm_inputs(t, b, h, torch.float32,
                                              device, 7, ndir=1))
    ms = cs.cuda_ms(lambda: L.lstm_fwd(*args), 3)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(int(seconds * 1e3 / ms)):
            L.lstm_fwd(*args)
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    rows = [[float(v) for v in line.split(",")] for line in out.splitlines()
            if line.count(",") == 2]
    med = [sorted(col)[len(col) // 2] for col in zip(*rows)]
    tflops = 2 * b * h * 4 * h * t / ms / 1e9
    cs.log(f"  lstm_wide.cu (298, 4096, 512) fp32 back to back: {ms:.4f} ms "
           f"a launch, {tflops:.1f} TFLOP/s; {len(rows)} samples, median SM "
           f"clock {med[0]:.0f} MHz, power {med[1]:.1f} W, {med[2]:.0f} C")
    return {"ms": ms, "tflops": tflops, "samples": rows}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--shapes", default=",".join(s[0] for s in SHAPES))
    ap.add_argument("--parent", default=None)
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    SHAPES[:] = [s for s in SHAPES if s[0] in args.shapes.split(",")]
    if not torch.cuda.is_available():
        sys.exit("lstm_wide_variants: needs a CUDA device")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cs.log(smi.stdout.strip())
    cuda_build.build(["lstm_wide"])
    if args.sass:
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "sass.json").write_text(json.dumps(sass_mix(), indent=1))
    if args.clocks:
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "clocks.json").write_text(json.dumps(clocks(device)))
    names = [n for n in args.variants.split(",") if n and n != "parent"]
    if args.parent:
        names = ["parent"] + names
    if names:
        variants(names, device, args.parent)


if __name__ == "__main__":
    main()
