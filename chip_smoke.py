#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (fnssl_tpu_torch) on one GPU.

  python3 chip_smoke.py [--seed N] [--out DIR]

Phases, each fatal on failure (exit code != 0, no result line):
  1. device  — the card's name and power limit (nvidia-smi); no CUDA, no run.
  2. build   — nvcc builds every kernel from the sources in the checkout
               (lstm_cluster.cu, lstm_fwd.cu), one nvcc per source, all
               started together.
  3. kernels — each kernel against its plain PyTorch version on the card:
               the cluster kernel through lstm_fwd (both directions) and
               lstm_fwd_bidir at the main path's shapes and at edge cases
               (B 1/11/13/17, T 0/1/2/7, H 32/64/128/256), fp32 and bf16,
               nonzero h0/c0; lstm_fwd.cu at H = 512, its only use.
  4. serve   — `cli serve --model fnssl` at full width (fresh weights from
               --seed) on cuda:0 answers 3 TCP connections of 5 s of 2-channel
               16 kHz audio; launch counts (6 a chunk step), eof counts, and
               agreement with the same pipeline on the CPU (plain versions)
               are checked.
  5. times   — each kernel at the main path's shapes (CUDA events, warm):
               the cluster kernel one direction and, at full band, both in
               one launch; lstm_fwd.cu; the plain version; the bound; and
               torch.nn.LSTM (cuDNN, one- and bidirectional) as the library
               yardstick (the port never calls it). Then every cluster plan
               (N, Bt, KS) that fits at the two serve shapes.
The line before the last is the kernels JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores (the kernel's FMAs are float32 for both xg dtypes)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
TOL = {"float32": {"ys": 1e-4, "hT": 1e-4, "cT": 1e-4},
       "bfloat16": {"ys": 2e-2, "hT": 1e-4, "cT": 1e-4}}
SERVE_AUDIO_S = 5.0
FS = 16000
# (name, T, B, H, I): the recurrences of one chunk step of the serve path
# (nb=1, P=1, 12 frames, nf=256) and of a one-shot 4.79 s forward (nt=298)
SHAPES = [("serve_fullband", 256, 12, 128, 256),
          ("serve_narrowband", 12, 256, 256, 256),
          ("oneshot_fullband", 256, 298, 128, 256),
          ("oneshot_narrowband", 298, 256, 256, 256)]
# recurrences of each shape in one online chunk step (3 FN blocks): a
# BiLSTM over frequency (both directions in one launch of the cluster
# kernel, two of lstm_fwd.cu) and a one-direction LSTM over time
PER_CHUNK = {"serve_fullband": 3, "serve_narrowband": 3}
LAUNCHES_PER_CHUNK = 6
EDGE_B, EDGE_T, EDGE_H = (1, 11, 13, 17), (0, 1, 2, 7), (32, 64, 128, 256)
V2_CASE = (5, 13, 512)                  # (T, B, H): lstm_fwd.cu serves H > 256


def log(msg):
    print(msg, flush=True)


def lstm_inputs(t_steps, batch, hidden, dtype, device, seed, ndir=None):
    """Recurrence inputs; with ndir, stacked (ndir, ...) for lstm_fwd_bidir."""
    lead = () if ndir is None else (ndir,)
    g = torch.Generator().manual_seed(seed)
    xg = torch.randn(*lead, t_steps, batch, 4 * hidden, generator=g)
    w = torch.randn(*lead, hidden, 4 * hidden, generator=g) / hidden ** 0.5
    h0 = torch.randn(*lead, batch, hidden, generator=g) * 0.5
    c0 = torch.randn(*lead, batch, hidden, generator=g) * 0.5
    return (xg.to(device, dtype), w.to(device, dtype), h0.to(device),
            c0.to(device))


def held(kernel, what, dtype, got, want, worst):
    """Max |kernel - plain| of ys, hT, cT against TOL; folds them into
    worst[kernel]."""
    torch.cuda.synchronize()
    errs = {k: (g.float() - w.float()).abs().max().item() if g.numel()
            else 0.0 for k, g, w in zip(("ys", "hT", "cT"), got, want)}
    for k, v in errs.items():
        if not v <= TOL[dtype][k]:
            raise AssertionError(f"{kernel} {what} {dtype}: {k} max|diff| "
                                 f"{v} > {TOL[dtype][k]}")
    w = worst[kernel]
    if dtype == "float32":
        w["float32"] = max(w["float32"], *errs.values())
    else:
        w["bfloat16_ys"] = max(w["bfloat16_ys"], errs["ys"])
        w["bfloat16"] = max(w["bfloat16"], errs["hT"], errs["cT"])
    return errs


def counted(counter, n, fn, *args, **kwargs):
    """fn(*args) and a check that it launched exactly n kernels."""
    before = counter.value
    out = fn(*args, **kwargs)
    if counter.value != before + n:
        raise AssertionError(f"{fn.__name__} launched "
                             f"{counter.value - before} times, expected {n}")
    return out


def phase_kernels(device):
    """K1 against its plain version on the card. Returns the worst errors
    by kernel and dtype, and the number of checks."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    worst = {k: {"float32": 0.0, "bfloat16": 0.0, "bfloat16_ys": 0.0}
             for k in ("lstm_cluster", "lstm_fwd")}
    cases = [(n, t, b, h) for n, t, b, h, _ in SHAPES]
    cases += [("edge", t, b, h) for h in EDGE_H for b in EDGE_B
              for t in EDGE_T]
    cases += [("v2_h512", *V2_CASE)]
    seed, checks = 0, 0
    for name, t, b, h in cases:
        kernel = "lstm_fwd" if h > L.CLUSTER_MAX_HIDDEN else "lstm_cluster"
        counter = L.launches_v2 if kernel == "lstm_fwd" else L.launches
        for dtype in ("float32", "bfloat16"):
            seed += 1
            both = lstm_inputs(t, b, h, getattr(torch, dtype), device, seed,
                               ndir=2)
            errs = []
            for reverse in (False, True):
                one = tuple(a[int(reverse)] for a in both)
                got = counted(counter, 1, L.lstm_fwd, *one, reverse=reverse)
                errs.append(held(kernel, f"{name} lstm_fwd reverse="
                                 f"{int(reverse)}", dtype, got,
                                 L.lstm_fwd_plain(*one, reverse=reverse),
                                 worst))
            got = counted(counter, 1 if kernel == "lstm_cluster" else 2,
                          L.lstm_fwd_bidir, *both)
            errs.append(held(kernel, f"{name} lstm_fwd_bidir", dtype, got,
                             L.lstm_fwd_bidir_plain(*both), worst))
            checks += 3
            if name != "edge":
                log(f"  {kernel} {name:18s} T={t:3d} B={b:3d} H={h:3d} "
                    f"{dtype:8s} max|diff| fwd/rev/bidir ys "
                    + "/".join(f"{e['ys']:.2e}" for e in errs) + " hT,cT "
                    + "/".join(f"{max(e['hT'], e['cT']):.2e}" for e in errs))
    log(f"  {checks} checks passed; edge cases B {EDGE_B} x T {EDGE_T} x "
        f"H {EDGE_H}; worst {json.dumps(worst)}")
    return worst


def make_audio(seed, delay):
    """Noise reaching mic 2 `delay` samples after mic 1, plus a little
    independent noise on each mic."""
    rng = np.random.default_rng(seed)
    n = int(SERVE_AUDIO_S * FS)
    src = rng.standard_normal(n + abs(delay)).astype(np.float32) * 0.1
    m1 = src[abs(delay): abs(delay) + n] if delay >= 0 else src[:n]
    m2 = src[:n] if delay >= 0 else src[abs(delay): abs(delay) + n]
    sig = np.stack([m1, m2], axis=1)
    return sig + rng.standard_normal(sig.shape).astype(np.float32) * 0.01


def cpu_reference(seed, sig, block):
    """The same pipeline on the CPU, through the plain versions."""
    from fnssl_tpu_torch.eval.pred_doa import PredDOA
    from fnssl_tpu_torch.models.fnssl import FNSSL
    from fnssl_tpu_torch.runtime.streaming import (StreamingLocalizer,
                                                   make_fnssl_stream_step)

    model = FNSSL(device="cpu",
                  generator=torch.Generator().manual_seed(seed)).eval()
    loc = StreamingLocalizer(make_fnssl_stream_step(model), nch=2,
                             device="cpu")
    decoder = PredDOA(device="cpu")
    outs, doas, ss = [], [], []
    for start in range(0, sig.shape[0], block):
        for out in loc.push(sig[start: start + block]):
            res = decoder.predgt2doa(out)[0]
            outs.append(out)
            doas.append(np.degrees(res["doa"].numpy())[0])
            ss.append(res["spatial_spectrum"].numpy()[0])
    return outs, doas, ss


def phase_serve(seed, device):
    """Drive `cli serve --model fnssl` on the card over TCP."""
    from fnssl_tpu_torch.cli.main import build_parser, build_server
    from fnssl_tpu_torch.kernels import lstm_cuda
    from fnssl_tpu_torch.runtime.server import stream_client

    block = 1600
    sessions = []

    with tempfile.TemporaryDirectory() as log_dir:
        args = build_parser().parse_args(
            ["serve", "--model", "fnssl", "--port", "0", "--seed",
             str(seed), "--log-dir", log_dir])
        server, info = build_server(args)
    log(f"  placement: {json.dumps(info)}")
    if info["model_device"] != str(device):
        raise AssertionError(f"model on {info['model_device']}, "
                             f"expected {device}")
    make_session = server.session_factory

    def timed_session():
        loc, decode = make_session()
        step = loc.model_step
        rec = {"loc": loc, "ms": [], "outs": []}

        def wrapped(feats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(feats)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["outs"].append(out.cpu())
            return out

        loc.model_step = wrapped
        sessions.append(rec)
        return loc, decode

    server.session_factory = timed_session
    server.start()
    conns = [(seed + 100 + k, d) for k, d in enumerate((3, -5, 0))]
    try:
        lstm_cuda.launches.reset()
        lstm_cuda.launches_v2.reset()
        replies = [stream_client("127.0.0.1", server.port,
                                 make_audio(s, d), block=block)
                   for s, d in conns]
        launches = lstm_cuda.launches.value
        launches_v2 = lstm_cuda.launches_v2.value
    finally:
        server.shutdown()

    n = int(SERVE_AUDIO_S * FS)
    expected_steps = ((n - 512) // 256 + 1) // 12
    steps = 0
    for (s, d), msgs, rec in zip(conns, replies, sessions):
        n_steps = len(rec["ms"])
        steps += n_steps
        eof = msgs[-1]
        if eof != {"eof": True, "outputs": len(msgs) - 1}:
            raise AssertionError(f"connection {s}: bad eof {eof}")
        if not len(msgs) - 1 == n_steps == expected_steps:
            raise AssertionError(f"connection {s}: {len(msgs) - 1} lines "
                                 f"for {n_steps} chunk steps")
        outs, doas, ss = cpu_reference(seed, make_audio(s, d), block)
        if len(outs) != n_steps:
            raise AssertionError(f"connection {s}: CPU fired {len(outs)}")
        out_err = max((g - w).abs().max().item()
                      for g, w in zip(rec["outs"], outs))
        if not out_err <= 1e-3:
            raise AssertionError(f"connection {s}: FN-SSL output max|diff| "
                                 f"{out_err} vs the CPU > 1e-3")
        mismatched = 0
        for msg, want, spec in zip(msgs[:-1], doas, ss):
            if np.allclose(msg["doa_deg"], np.round(want[0], 3), atol=1e-3):
                continue
            top2 = np.sort(spec.ravel())[-2:]
            if top2[1] - top2[0] > 1e-3:       # not an exact tie
                raise AssertionError(f"connection {s} t={msg['t']}: served "
                                     f"{msg['doa_deg']}, CPU {want[0]}")
            mismatched += 1
        azis = [m["doa_deg"][1][0] for m in msgs[:-1]]
        log(f"  connection seed={s} delay={d:+d}: {n_steps} chunk steps, "
            f"eof ok, FN-SSL max|diff| vs CPU {out_err:.3e}, DOAs equal "
            f"(ties {mismatched}), median azimuth {np.median(azis):.1f} deg")

    if launches != LAUNCHES_PER_CHUNK * steps or launches_v2 != 0:
        raise AssertionError(
            f"K1 launched {launches} times (lstm_cluster) and {launches_v2} "
            f"(lstm_fwd) for {steps} chunk steps (expected "
            f"{LAUNCHES_PER_CHUNK * steps} and 0)")
    ms = np.concatenate([rec["ms"][1:] for rec in sessions])
    rtf = [rec["loc"].rtf for rec in sessions]
    log(f"  K1 launches {launches} = {LAUNCHES_PER_CHUNK} x {steps} chunk "
        f"steps, all lstm_cluster")
    log(f"  model step ms (warm, synchronized): mean {ms.mean():.3f} "
        f"p90 {np.percentile(ms, 90):.3f} over {ms.size} steps; RTF per "
        f"connection {', '.join(f'{r:.4f}' for r in rtf)}")
    return {"lstm_cluster": launches, "lstm_fwd": launches_v2}, steps, {
        "model_step_ms_mean": float(ms.mean()),
        "model_step_ms_p90": float(np.percentile(ms, 90)),
        "rtf_per_connection": rtf}


def cuda_ms(fn, iters):
    for _ in range(2):
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


def enqueue_ms(fn, iters):
    """Host time to enqueue one call (no synchronize inside the loop): a
    kernel time near it is set by the host, not the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def bound_terms(t_steps, batch, hidden, itemsize):
    """The least time (ms) one recurrence needs for its bytes (each input
    read once, each output written once) and for its FLOPs."""
    nbytes = (t_steps * batch * 4 * hidden * itemsize     # xg read
              + t_steps * batch * hidden * itemsize       # ys write
              + hidden * 4 * hidden * itemsize            # W_hh read
              + 4 * batch * hidden * 4)                   # h0 c0 hT cT
    flops = 2 * batch * hidden * 4 * hidden * t_steps
    return {"bytes": nbytes / HBM_BYTES_S * 1e3,
            "operations": flops / FP32_FLOP_S * 1e3}


def bound(terms):
    """(bound_ms, bound_by): the larger of the two terms."""
    by = max(terms, key=terms.get)
    return terms[by], by


def lstm_v2(args):
    """lstm_fwd.cu at any H it takes (the wrappers reach it only above
    H = 256), to time the earlier design at the main path's shapes."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    xg, w = args[:2]
    outs = L._outputs(xg, args[2], (*xg.shape[:2], w.shape[0]))
    L._launch_v2(*args, outs, False)
    return outs


def library_lstm(i, h, w_hh_t, bidirectional, device):
    ref = torch.nn.LSTM(i, h, batch_first=True,
                        bidirectional=bidirectional).to(device)
    with torch.no_grad():
        ref.weight_hh_l0.copy_(w_hh_t[0].T)
        if bidirectional:
            ref.weight_hh_l0_reverse.copy_(w_hh_t[1].T)
    return ref


def phase_times(device):
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    rows = []
    for name, t, b, h, i in SHAPES:
        full = name.endswith("fullband")
        row = {"shape": name, "T": t, "B": b, "H": h,
               "plan": L.cluster_plan(h, 4, b)}
        for dtype in ("float32", "bfloat16"):
            itemsize = 4 if dtype == "float32" else 2
            both = lstm_inputs(t, b, h, getattr(torch, dtype), device, 7,
                               ndir=2)
            one = tuple(a[0] for a in both)
            row[f"ms_{dtype}"] = cuda_ms(lambda: L.lstm_fwd(*one), 20)
            row[f"enqueue_ms_{dtype}"] = enqueue_ms(lambda: L.lstm_fwd(*one),
                                                    20)
            row[f"v2_ms_{dtype}"] = cuda_ms(lambda: lstm_v2(one), 20)
            terms = bound_terms(t, b, h, itemsize)
            row[f"bound_terms_{dtype}"] = terms
            row[f"bound_ms_{dtype}"], row[f"bound_by_{dtype}"] = bound(terms)
            if full:
                row[f"fused_ms_{dtype}"] = cuda_ms(
                    lambda: L.lstm_fwd_bidir(*both), 20)
                row[f"fused_bound_ms_{dtype}"], _ = bound(
                    {k: 2 * v for k, v in terms.items()})
        # the main path's launch (fused at full band) at T = 1: its cost
        # apart from the steps
        short = lstm_inputs(1, b, h, torch.float32, device, 7,
                            ndir=2 if full else None)
        fn = L.lstm_fwd_bidir if full else L.lstm_fwd
        row["t1_ms_float32"] = cuda_ms(lambda: fn(*short), 20)
        both = lstm_inputs(t, b, h, torch.float32, device, 7, ndir=2)
        one = tuple(a[0] for a in both)
        row["plain_ms"] = cuda_ms(lambda: L.lstm_fwd_plain(*one), 3)
        x = torch.randn(b, t, i, device=device)
        with torch.no_grad():
            ref = library_lstm(i, h, both[1], False, device)
            state = (one[2][None], one[3][None])
            row["library_ms"] = cuda_ms(lambda: ref(x, state), 20)
            if full:
                row["fused_plain_ms"] = cuda_ms(
                    lambda: L.lstm_fwd_bidir_plain(*both), 3)
                ref2 = library_lstm(i, h, both[1], True, device)
                row["library_bidir_ms"] = cuda_ms(
                    lambda: ref2(x, (both[2], both[3])), 20)
        rows.append(row)
        log(f"  K1 {name:18s} T={t:3d} B={b:3d} H={h:3d} plan "
            f"(N, Bt, KS)={row['plan']}: cluster fp32 {row['ms_float32']:.4f}"
            f" ms (enqueue {row['enqueue_ms_float32']:.4f}, at T=1 "
            f"{row['t1_ms_float32']:.4f}), bf16 "
            f"{row['ms_bfloat16']:.4f} ms; lstm_fwd.cu fp32 "
            f"{row['v2_ms_float32']:.4f} ms, bf16 {row['v2_ms_bfloat16']:.4f}"
            f" ms; bound fp32 {row['bound_ms_float32']:.5f} ms "
            f"({row['bound_by_float32']}); plain {row['plain_ms']:.3f} ms; "
            f"nn.LSTM(cuDNN, I={i}) {row['library_ms']:.4f} ms")
        if full:
            log(f"  K1 {name:18s} both directions: fused fp32 "
                f"{row['fused_ms_float32']:.4f} ms, bf16 "
                f"{row['fused_ms_bfloat16']:.4f} ms; bound fp32 "
                f"{row['fused_bound_ms_float32']:.5f} ms; plain "
                f"{row['fused_plain_ms']:.3f} ms; nn.LSTM bidirectional "
                f"{row['library_bidir_ms']:.4f} ms")
    return rows


def phase_plans(device):
    """Every cluster plan that fits at the two serve shapes, fp32: the
    fused full-band launch and the one-direction narrow-band launch."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    rows = []
    for name, t, b, h, _ in SHAPES[:2]:
        full = name.endswith("fullband")
        args = lstm_inputs(t, b, h, torch.float32, device, 7,
                           ndir=2 if full else None)
        fn = L.lstm_fwd_bidir if full else L.lstm_fwd
        default = L.cluster_plan(h, 4, b)
        for n in L.CLUSTER_SIZES:
            for bt in L.TILES:
                for ks in (h // 16, h // 8):
                    try:
                        plan = L.cluster_plan(h, 4, b, n=n, bt=bt, ks=ks)
                    except ValueError:
                        continue                 # does not fit
                    ms = cuda_ms(lambda: fn(*args, plan=plan), 20)
                    rows.append({"shape": name, "N": n, "Bt": bt, "KS": ks,
                                 "ms": ms, "default": plan == default})
                    log(f"  {name:18s} N={n} Bt={bt:2d} KS={ks:2d}: "
                        f"{ms:.4f} ms{' (default)' if plan == default else ''}")
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--out", default="results/chip_smoke",
                    help="where the full report (JSON) is written")
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this smoke test runs only on "
                 "the card")
    import fnssl_tpu_torch  # fails outside the checkout
    if Path(fnssl_tpu_torch.__file__).resolve().parents[1] != ROOT:
        sys.exit(f"chip_smoke: fnssl_tpu_torch comes from "
                 f"{fnssl_tpu_torch.__file__}, not from this checkout")
    from fnssl_tpu_torch.kernels import cuda_build

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    reports = cuda_build.build(["lstm_cluster", "lstm_fwd"])
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        spills = [line.strip() for line in report.splitlines()
                  if re.search(r"[1-9]\d* bytes spill stores", line)]
        log(f"  {name}: {len(spills)} kernel instances spill"
            + "".join(f"\n    {line}" for line in spills))

    # 3. kernels against their plain versions
    log("[kernels] K1 against its plain version on the card")
    worst = phase_kernels(device)

    # 4. serve
    log("[serve] cli serve --model fnssl on the card, 3 TCP connections")
    launches, steps, step = phase_serve(args.seed, device)

    # 5. times
    log("[times] K1 at the main path's shapes")
    rows = phase_times(device)
    log("[plans] lstm_cluster plans at the serve shapes, fp32")
    plans = phase_plans(device)

    # each kernel's work in one online chunk step, fp32: 3 BiLSTMs over
    # frequency and 3 LSTMs over time
    serve = {r["shape"]: r for r in rows if r["shape"] in PER_CHUNK}
    full, narrow = serve["serve_fullband"], serve["serve_narrowband"]
    nf, nn_ = PER_CHUNK["serve_fullband"], PER_CHUNK["serve_narrowband"]
    plain_ms = nf * full["fused_plain_ms"] + nn_ * narrow["plain_ms"]
    library_ms = (nf * full["library_bidir_ms"]
                  + nn_ * narrow["library_ms"])
    bound_ms, bound_by = bound(
        {k: 2 * nf * full["bound_terms_float32"][k]
         + nn_ * narrow["bound_terms_float32"][k]
         for k in ("bytes", "operations")})
    common = {"replaces": "fnssl_tpu/kernels/lstm_pallas.py:50",
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms,
              "work": "the recurrences of one online chunk step, fp32: 3 "
                      "full-band BiLSTMs (T=256, B=12, H=128) and 3 "
                      "narrow-band LSTMs (T=12, B=256, H=256)"}
    kernels = [{
        "name": "lstm_cluster", "route": "cuda",
        "source": "fnssl_tpu_torch/kernels/csrc/lstm_cluster.cu",
        "launches": launches["lstm_cluster"],
        "max_abs_err": worst["lstm_cluster"]["float32"],
        "ms": nf * full["fused_ms_float32"] + nn_ * narrow["ms_float32"],
        **common,
        "launches_per_chunk_step": LAUNCHES_PER_CHUNK,
        "chunk_steps": steps, **step,
        "max_abs_err_bf16_ys": worst["lstm_cluster"]["bfloat16_ys"],
        "per_shape": rows, "plans": plans,
    }, {
        "name": "lstm_fwd", "route": "cuda",
        "source": "fnssl_tpu_torch/kernels/csrc/lstm_fwd.cu",
        "launches": launches["lstm_fwd"],
        "max_abs_err": worst["lstm_fwd"]["float32"],
        "ms": 2 * nf * full["v2_ms_float32"] + nn_ * narrow["v2_ms_float32"],
        **common,
        "note": "serves H > 256 only (checked at H=512); not on FN-SSL's "
                "main path, so 0 launches there; ms is the same chunk "
                "step's work in 9 launches of this kernel",
        "max_abs_err_bf16_ys": worst["lstm_fwd"]["bfloat16_ys"],
    }]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kind": kind, "kernels": kernels}, indent=1))
    log(json.dumps({"kernels": [{k: v for k, v in kern.items()
                                  if k != "plans"} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
