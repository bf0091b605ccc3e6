#!/usr/bin/env python3
"""Times K2 above H = 256 (FN-SSL at hidden_size 512): lstm_bwd_wide.cu in
turns with another tree's, with variants of itself, its plans against each
other, and the hidden-512 train cell.

  python3 /path/to/tools/lstm_bwd_wide_cells.py [--parent DIR] [--sweep]
      [--plans] [--variants a,b] [--passes] [--cells] [--out DIR]
      [--seed N]

Run from the root of a checkout (it imports that checkout's
``fnssl_tpu_torch`` and ``chip_smoke.py``). Every mode first builds the
tree's kernels and prints nvcc's ``-Xptxas -v`` lines for lstm_bwd_wide.cu
(registers and spills of each kernel instance), and those of every other
library it builds.

``--sweep`` (needs ``--parent DIR``, a tree holding
``fnssl_tpu_torch/kernels/csrc/lstm_bwd_wide.cu``, e.g. the parent commit
unpacked with ``git archive``): builds DIR's lstm_bwd_wide.cu beside this
tree's kernels and, at each point of SWEEP (T, B, H) x 1 and 2 directions x
fp32 and bf16, holds both against the plain version (``lstm_bwd_plain``;
dgates, dh0 and dc0 within chip_smoke's BWD_TOL, at T cut to CHECK_T: the
plans do not depend on T) and times them in turns, parent, change, change,
parent (CUDA events, warm), each with its tree's rule's plan (DIR's rule is
copied here as ``parent_plan``); fails where this tree measured slower than
DIR's by more than SLOWER (2%: two builds of one source differ by up to
0.7%).

``--plans``: at each point of PLAN_POINTS, fp32 and bf16, every plan
``bwd_wide_plans`` gives, in rounds (each round times every entry once,
the first also last; with ``--parent DIR`` DIR's kernel at its rule's plan
too), after holding each against the plain version at T = CHECK_T. What
sets the rule. ``--variants a,b`` adds builds of this tree's source with
the text substitutions of VARIANTS, at the rule's plan: ``kb4``, W_hh
register blocks of 4 k's (as below R = 4) at the 16-row tile too, in
place of 8; ``k0``, every CTA starting the step's product at k = 0 (one
order for all) in place of 8 offsets; ``w_bf16``, W_hh read in ys' dtype
and widened in registers (under bf16, half the bytes from L2); and the
cuts, which leave out part of the work to show what it costs and are not
held against the plain version: ``cut_w`` (W_hh read from 8 rows, cached
in L1, for every k: the product without W_hh's L2 traffic and latency)
and ``cut_dg`` (dgates read from 2 rows: the product without most of its
shared-memory loads).
``--passes`` adds tools/lstm_bwd_wide_passes.cu, the 32-row tile in two
passes over the gate blocks, at its plan (8, 1, 2), where H is up to 512:
as it stands (4-k register blocks, CTAs starting each pass at 8 offsets of
k, as the package source does) and with every CTA starting at k = 0
(``passes_k0``, beside the package's own ``k0`` variant).

``--cells``: FN-SSL at FNSSLConfig(hidden_size=512), nb 16 x 4.79 s, fp32
then the bf16 policy, 1 warm + chip_smoke.WIDE_STEPS timed steps each (ms a
step, peak memory), and one traced step each: K2's device ms by kernel, the
card's busy time. Run it from each tree's root in turns to compare them.

Writes ``DIR/lstm_bwd_wide_cells.json`` (default
``results/lstm_bwd_wide_cells``) and the variant builds beside it.
"""
from __future__ import annotations

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
HERE = Path(__file__).resolve().parent

# (T, B, H): hidden 512's narrow band in training (nb 16) and at 8 scenes,
# its parity step's (nb 1 x 2 s), chip_smoke's V2_CASE, and H 768 / 1024
# (T cut to 64: the plans do not depend on T) at B 4096 and 13
SWEEP = [(298, 4096, 512), (298, 2048, 512), (124, 256, 512), (5, 13, 512),
         (64, 4096, 768), (64, 4096, 1024), (5, 13, 1024)]
PLAN_POINTS = [(298, 4096, 512, 1), (298, 2048, 512, 1), (64, 4096, 768, 1),
               (64, 4096, 1024, 1), (124, 256, 512, 1), (5, 13, 512, 1),
               (5, 13, 512, 2)]
CHECK_T = 9                       # T of the checks against the plain version
SLOWER = 0.02                     # what --sweep tolerates against DIR's
K2_KERNELS = ("lstm_bwd_cluster_kernel", "lstm_bwd_wave_kernel",
              "lstm_bwd_wide_kernel")
_LOAD_W = ("          w_hh + static_cast<size_t>(k0 + e) * hidden + "
           "u[j]));")
_LOAD_DG = ("      const float4 d4 = *reinterpret_cast<const float4*>(\n"
            "          dgrow + i * row_stride + k0 + h);")
_FIRST = ("  // CTAs start the product at 8 offsets of k, spread over L2\n"
          "  const int k_off = (blockIdx.x & 7) * (four_h / 8);\n"
          "  load_block<J, KB>(w0, a.w_hh, k_off, u, hidden);\n")
_FIRST_ZERO = "  load_block<J, KB>(w0, a.w_hh, 0, u, hidden);\n"
_STEP = """      int k = kg + k_off;
      k = k < four_h ? k : k - four_h;
"""
_STEP_ZERO = """      const int k = kg;
"""
# W_hh read in ys' dtype and widened in registers (a bfloat16 W_hh: half
# the bytes from L2; widening is exact)
_W_BF16 = [
    ("  const float* w_hh;\n  const float* c0;\n  const T_in* dys;",
     "  const T_in* w_hh;\n  const float* c0;\n  const T_in* dys;"),
    ("    float* g, float* cs, const float* w_hh, const float* c0, "
     "const T_in* dys,",
     "    float* g, float* cs, const T_in* w_hh, const float* c0, "
     "const T_in* dys,"),
    ("                     const float* __restrict__ w_hh,\n",
     "                     const T_in* __restrict__ w_hh,\n"),
    ("template <int J, int KB>\n__device__ __forceinline__ void load_block("
     "float4 (&w)[J][KB],\n                                           const "
     "float* w_hh, int k0,",
     "__device__ __forceinline__ float4 ldg4(const float* p) {\n"
     "  return __ldg(reinterpret_cast<const float4*>(p));\n}\n\n"
     "__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {\n"
     "  return widen(__ldg(reinterpret_cast<const uint2*>(p)));\n}\n\n"
     "template <int J, int KB, typename T_w>\n__device__ __forceinline__ "
     "void load_block(float4 (&w)[J][KB],\n                             "
     "              const T_w* w_hh, int k0,"),
    ("      w[j][e] = __ldg(reinterpret_cast<const float4*>(\n"
     "          w_hh + static_cast<size_t>(k0 + e) * hidden + u[j]));",
     "      w[j][e] = ldg4(w_hh + static_cast<size_t>(k0 + e) * hidden + "
     "u[j]);"),
    ("stream>>>(a.g, a.cs, a.w_hh, a.c0,",
     "stream>>>(a.g, a.cs, static_cast<const T_in*>(static_cast<const "
     "void*>(a.w_hh)), a.c0,"),
]
# name: (text substitutions, computes the same function[, W_hh in ys'
# dtype])
VARIANTS = {
    "kb4": ([("constexpr int block_k(int r) { return r == 4 ? 8 : 4; }",
              "constexpr int block_k(int r) { return 4; }")], True),
    "cut_w": ([(_LOAD_W, "          w_hh + static_cast<size_t>((k0 + e) & 7)"
                " * hidden + u[j]));")], False),
    "cut_dg": ([(_LOAD_DG, "      const float4 d4 = *reinterpret_cast<const "
                 "float4*>(\n          dgrow + 4 * (i & 1) + k0 + h);")],
               False),
    "k0": ([(_FIRST, _FIRST_ZERO), (_STEP, _STEP_ZERO)], True),
    "w_bf16": (_W_BF16, True, True),
}
# variants that take W_hh in ys' dtype (the others, as the package, float32)
RAW_W = {name for name, v in VARIANTS.items() if len(v) > 2}
PASSES_PLAN = (8, 1, 2)
# the two-pass variant's builds: with the package's 8 offsets of k, and
# from k = 0
PASSES_BUILDS = {"passes": [],
                 "passes_k0": [("  const int k_off = (blockIdx.x & 7) * "
                                "(span / 8);", "  const int k_off = 0;")]}


def parent_plan(hidden, batch, ndir):
    """The parent's rule: R of 4, 2, 1 rows a thread (2, 1 above H = 512),
    tiles of 4 R rows, one CTA an SM; the fewest rows on the busiest SM,
    on a tie the most rows a thread."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    best = None
    for rows in ((4, 2, 1) if hidden <= 512 else (2, 1)):
        tile = 4 * rows
        busiest = L._busiest(tile, -(-batch // tile) * ndir, 1)
        if best is None or busiest < best[0]:
            best = (busiest, rows)
    return best[1]


def build(src: Path, lib: Path, ints: int):
    """`src` built with this tree's nvcc flags into `lib`: (the library
    with `ints` int arguments after its 9 pointers, nvcc's report)."""
    from fnssl_tpu_torch.kernels import cuda_build

    done = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-o", str(lib), str(src)], capture_output=True,
                          text=True, timeout=900)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{done.stdout}"
                           f"{done.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.lstm_bwd_wide.argtypes = ([ctypes.c_void_p] * 9
                                  + [ctypes.c_int] * ints
                                  + [ctypes.c_void_p])
    dll.lstm_bwd_wide.restype = ctypes.c_int
    return dll, done.stdout + done.stderr


def substituted(src: Path, subs, out: Path) -> Path:
    text = src.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{out.name}: {old!r} is not in {src} once")
        text = text.replace(old, new)
    out.write_text(text)
    return out


def ext_bwd(dll, plan, g, w_hh, c0, dys, dh_t, dc_t, ndir, reverse,
            raw=False):
    """Another build's kernel over `ndir` stacked directions in one launch,
    as the package's wrapper launches it (a float32 W_hh unless `raw`, a
    float32 cs scratch); `plan` is the ints its entry point takes."""
    t_steps, batch, four_h = g.shape[-3:]
    w = w_hh if raw else w_hh.float()
    cs = torch.empty(dys.shape, dtype=torch.float32, device=g.device)
    dh0, dc0 = torch.empty_like(c0), torch.empty_like(c0)
    err = dll.lstm_bwd_wide(
        g.data_ptr(), cs.data_ptr(), w.data_ptr(), c0.data_ptr(),
        dys.data_ptr(), dh_t.data_ptr(), dc_t.data_ptr(), dh0.data_ptr(),
        dc0.data_ptr(), t_steps, batch, four_h // 4, ndir, int(reverse),
        int(dys.dtype == torch.bfloat16), *plan, g.device.index,
        torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"lstm_bwd_wide build failed: {err}")
    return g, dh0, dc0


def calls(ndir, plan=None):
    """(this tree's call at `plan` or its rule's, the plain version), each
    on a tuple of K2's inputs stacked `ndir` directions (1: lstm_bwd's walk
    forward)."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    if ndir == 2:
        return (lambda a: L.lstm_bwd_bidir(*a, plan=plan),
                lambda a: L.lstm_bwd_bidir_plain(*a))
    return (lambda a: tuple(o[None] for o in L.lstm_bwd(
        *(x[0] for x in a), plan=plan)),
        lambda a: tuple(o[None] for o in L.lstm_bwd_plain(
            *(x[0] for x in a))))


def held(cs, what, fn, plain, args):
    """Max |fn - plain| of dgates, dh0, dc0 on copies of g; fails above
    chip_smoke's BWD_TOL."""
    got = fn((args[0].clone(),) + tuple(args[1:]))
    want = plain((args[0].clone(),) + tuple(args[1:]))
    torch.cuda.synchronize()
    errs = {k: cs.max_abs_diff(a, b)
            for k, a, b in zip(("dgates", "dh0", "dc0"), got, want)}
    for k, v in errs.items():
        if not v <= cs.BWD_TOL:
            raise AssertionError(f"{what}: {k} max|diff| {v} > "
                                 f"{cs.BWD_TOL}")
    return max(errs.values())


def bound_ms(cs, t, b, h, ndir, itemsize):
    return cs.bound({k: ndir * v for k, v in
                     cs.bwd_bound_terms(t, b, h, itemsize).items()})[0]


def sweep(cs, dll, device):
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    rows, slower = [], []
    for t, b, h in SWEEP:
        for ndir in (1, 2):
            for dtype in ("float32", "bfloat16"):
                tdt = getattr(torch, dtype)
                old = lambda a: ext_bwd(  # noqa: E731
                    dll, (parent_plan(h, b, ndir),), *a, ndir, 0)
                mine, plain = calls(ndir)
                small = cs.bwd_inputs((ndir,), min(t, CHECK_T), b, h, tdt,
                                      device, 3)
                errs = {name: held(cs, f"{name} ({t}, {b}, {h}) ndir {ndir} "
                                   f"{dtype}", fn, plain, small)
                        for name, fn in (("change", mine), ("parent", old))}
                del small
                args = cs.bwd_inputs((ndir,), t, b, h, tdt, device, 4)
                iters = 3 if t * b * h * h > 2e10 else 20
                ms = {"parent": [], "change": []}
                for name in ("parent", "change", "change", "parent"):
                    fn = mine if name == "change" else old
                    ms[name].append(cs.cuda_ms(lambda: fn(args), iters))
                row = {"T": t, "B": b, "H": h, "ndir": ndir, "dtype": dtype,
                       "plan": L.bwd_wide_plan(h, b, ndir),
                       "parent_plan": parent_plan(h, b, ndir),
                       "change_ms": ms["change"], "parent_ms": ms["parent"],
                       "max_abs_err": errs,
                       "bound_ms": bound_ms(cs, t, b, h, ndir, tdt.itemsize)}
                rows.append(row)
                c_ms, p_ms = min(ms["change"]), min(ms["parent"])
                if c_ms > (1 + SLOWER) * p_ms:
                    slower.append((t, b, h, ndir, dtype))
                cs.log(f"  ({t}, {b}, {h}) ndir {ndir} {dtype}: change "
                       f"(R {row['plan']}) " + " ".join(
                           f"{v:.4f}" for v in ms["change"]) + " ms, parent "
                       f"(R {row['parent_plan']}) " + " ".join(
                           f"{v:.4f}" for v in ms["parent"])
                       + f" ms ({c_ms / p_ms - 1:+.2%}); bound "
                       f"{row['bound_ms']:.4f} ({row['bound_ms'] / c_ms:.0%}"
                       f" reached); max |diff| {errs['change']:.3g} "
                       f"(parent {errs['parent']:.3g})")
                del args
                torch.cuda.empty_cache()
    if slower:
        raise AssertionError(f"this tree measured slower than the parent's "
                             f"by more than {SLOWER:.0%} at {slower}")
    return rows


def plans(cs, others, device, rounds=2):
    """`others`: name -> (library, plan ints or None for DIR's rule, whether
    it computes the same function, the widths it takes)."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    out = []
    for t, b, h, ndir in PLAN_POINTS:
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            fns, same = {}, {}
            for p in L.bwd_wide_plans(h):
                fns[f"R {p}"] = calls(ndir, plan=p)[0]
                same[f"R {p}"] = True
            for name, (dll, plan, exact, widths) in others.items():
                if h not in widths:
                    continue
                plan = plan or (parent_plan(h, b, ndir) if name == "parent"
                                else L.bwd_wide_plan(h, b, ndir),)
                fns[name] = (lambda d, pl, raw: lambda a: ext_bwd(
                    d, pl, *a, ndir, 0, raw))(dll, plan, name in RAW_W)
                same[name] = exact
            plain = calls(ndir)[1]
            small = cs.bwd_inputs((ndir,), CHECK_T, b, h, tdt, device, 5)
            errs = {k: held(cs, f"{k} ({b}, {h}) {dtype}", fn, plain, small)
                    for k, fn in fns.items() if same[k]}
            del small
            args = cs.bwd_inputs((ndir,), t, b, h, tdt, device, 6)
            order = list(fns) + [next(iter(fns))]
            iters = 3 if t * b * h * h > 2e10 else 20
            ms = {k: [] for k in fns}
            for _ in range(rounds):
                for k in order:
                    ms[k].append(cs.cuda_ms(lambda: fns[k](args), iters))
            row = {"T": t, "B": b, "H": h, "ndir": ndir, "dtype": dtype,
                   "rule": L.bwd_wide_plan(h, b, ndir), "ms": ms,
                   "max_abs_err": errs,
                   "bound_ms": bound_ms(cs, t, b, h, ndir, tdt.itemsize)}
            out.append(row)
            cs.log(f"  ({t}, {b}, {h}) ndir {ndir} {dtype}, bound "
                   f"{row['bound_ms']:.3f} ms, rule R {row['rule']}: "
                   + "; ".join(f"{k} " + " ".join(f"{v:.3f}" for v in vs)
                               for k, vs in ms.items()))
            del args, fns
            torch.cuda.empty_cache()
    return out


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
        prof = cs.profile_step(lambda: step(state, batch, gen), K2_KERNELS)
        k2 = prof["ms_of"]
        out[precision] = {"ms": ms.tolist(), "ms_mean": float(ms.mean()),
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "losses": losses, "busy_ms": prof["busy_ms"],
                          "idle_share": prof["idle_share"],
                          "k2_device_ms": prof["groups_ms"].get("K2"),
                          "k2_by_kernel_ms": k2,
                          "groups_ms": prof["groups_ms"]}
        cs.log(f"  hidden {cs.WIDE_HIDDEN} {precision}: step ms "
               + " ".join(f"{v:.2f}" for v in ms) + f" (mean "
               f"{ms.mean():.2f}); peak "
               f"{out[precision]['peak_bytes'] / 2**30:.2f} GiB; traced: "
               f"busy {prof['busy_ms']:.2f} ms, K2 "
               f"{prof['groups_ms'].get('K2', 0.0):.2f} (" + ", ".join(
                   f"{k} {v:.2f}" for k, v in k2.items() if v) + ")")
        del state, step, batch
    return out


def ptxas_lines(report):
    """nvcc's -Xptxas -v lines: each kernel instance, its registers and
    spills."""
    return [ln.strip() for ln in report.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--variants", default="")
    ap.add_argument("--passes", action="store_true")
    ap.add_argument("--cells", action="store_true")
    ap.add_argument("--out", default="results/lstm_bwd_wide_cells")
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lstm_bwd_wide_cells: needs a CUDA device")
    if args.sweep and not args.parent:
        sys.exit("lstm_bwd_wide_cells: --sweep needs --parent DIR")
    import chip_smoke as cs
    from fnssl_tpu_torch.kernels import cuda_build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    cs.log(f"{card}; tree {ROOT}")
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    device = torch.device("cuda", 0)
    reports = cuda_build.build([p.stem for p in
                                sorted(cuda_build.CSRC.glob("*.cu"))])
    report = {"card": card, "tree": str(ROOT),
              "ptxas": {"package": ptxas_lines(reports.get("lstm_bwd_wide",
                                                           ""))}}
    src = cuda_build.CSRC / "lstm_bwd_wide.cu"
    jobs = {}                     # name: (source, ints, plan, exact, widths)
    if args.parent:
        jobs["parent"] = (Path(args.parent).resolve() / "fnssl_tpu_torch"
                          "/kernels/csrc/lstm_bwd_wide.cu", 8, None, True,
                          range(288, 1025, 32))
    for name in filter(None, args.variants.split(",")):
        subs, exact = VARIANTS[name][:2]
        jobs[name] = (substituted(src, subs, out / f"{name}.cu"), 8, None,
                      exact, range(288, 1025, 32))
    if args.passes:
        for name, subs in PASSES_BUILDS.items():
            jobs[name] = (substituted(HERE / "lstm_bwd_wide_passes.cu", subs,
                                      out / f"{name}.cu"), 10, PASSES_PLAN,
                          True, range(288, 513, 32))
    with ThreadPoolExecutor(max(1, len(jobs))) as pool:
        built = dict(zip(jobs, pool.map(
            lambda kv: build(kv[1][0], out / f"lib{kv[0]}.so", kv[1][1]),
            jobs.items())))
    others = {}
    for name, (dll, log) in built.items():
        report["ptxas"][name] = ptxas_lines(log)
        others[name] = (dll,) + jobs[name][2:]
    for name, lines in report["ptxas"].items():
        for ln in lines:
            cs.log(f"  [ptxas {name}] {ln}")
    if args.plans:
        cs.log("[plans] every plan of lstm_bwd_wide.cu at PLAN_POINTS, "
               f"beside {', '.join(others) or 'nothing else'}")
        report["plans"] = plans(cs, others, device)
    if args.sweep:
        cs.log(f"[sweep] lstm_bwd_wide.cu against {args.parent}'s")
        report["sweep"] = sweep(cs, built["parent"][0], device)
    if args.cells:
        cs.log(f"[cells] FN-SSL hidden {cs.WIDE_HIDDEN}, nb {cs.WIDE_NB}")
        report["cells"] = cells(cs, args.seed, device)
    (out / "lstm_bwd_wide_cells.json").write_text(json.dumps(report,
                                                             indent=1))


if __name__ == "__main__":
    main()
