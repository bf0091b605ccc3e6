#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (fnssl_tpu_torch) on one GPU.

  python3 chip_smoke.py [--seed N] [--out DIR]

Phases, each fatal on failure (exit code != 0, no result line):
  1. device  — the card's name and power limit (nvidia-smi); no CUDA, no run.
  2. build   — nvcc builds every kernel from the sources in the checkout,
               one nvcc per source, all started together.
  3. kernels — each kernel against its plain PyTorch version on the card,
               at the main path's shapes (fp32 and bf16, both directions)
               and at edge shapes (ragged B, short T, H = 64).
  4. serve   — `cli serve --model fnssl` at full width (fresh weights from
               --seed) on cuda:0 answers 3 TCP connections of 5 s of 2-channel
               16 kHz audio; launch counts, eof counts, and agreement with
               the same pipeline on the CPU (plain versions) are checked.
  5. times   — each kernel at the main path's shapes (CUDA events, warm),
               its plain version, its bound, and torch.nn.LSTM (cuDNN) as
               the library yardstick (the port never calls it).
The line before the last is the kernels JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
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
# launches of each shape in one online chunk step: 3 blocks × 2 / × 1
PER_CHUNK = {"serve_fullband": 6, "serve_narrowband": 3}


def log(msg):
    print(msg, flush=True)


def lstm_inputs(t_steps, batch, hidden, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    xg = torch.randn(t_steps, batch, 4 * hidden, generator=g)
    w = torch.randn(hidden, 4 * hidden, generator=g) / hidden ** 0.5
    h0 = torch.randn(batch, hidden, generator=g) * 0.5
    c0 = torch.randn(batch, hidden, generator=g) * 0.5
    return (xg.to(device, dtype), w.to(device, dtype), h0.to(device),
            c0.to(device))


def phase_kernels(device):
    """K1 against its plain version on the card. Returns the worst errors
    by dtype."""
    from fnssl_tpu_torch.kernels import lstm_cuda

    cases = [(n, t, b, h) for n, t, b, h, _ in SHAPES]
    cases += [("ragged", t, 11, 64) for t in (1, 2, 7)]
    cases += [("h64", 298, 37, 64), ("h32", 5, 3, 32)]
    worst = {"float32": 0.0, "bfloat16": 0.0, "bfloat16_ys": 0.0}
    seed = 0
    for name, t, b, h in cases:
        for dtype in ("float32", "bfloat16"):
            for reverse in (False, True):
                seed += 1
                args = lstm_inputs(t, b, h, getattr(torch, dtype), device,
                                   seed)
                got = lstm_cuda.lstm_fwd(*args, reverse=reverse)
                torch.cuda.synchronize()
                want = lstm_cuda.lstm_fwd_plain(*args, reverse=reverse)
                errs = {k: (g.float() - w.float()).abs().max().item()
                        for k, g, w in zip(("ys", "hT", "cT"), got, want)}
                log(f"  K1 {name:20s} T={t:3d} B={b:3d} H={h:3d} "
                    f"{dtype:8s} reverse={int(reverse)} max|diff| "
                    + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
                for k, v in errs.items():
                    if not v <= TOL[dtype][k]:
                        raise AssertionError(
                            f"K1 {name} {dtype} reverse={reverse}: {k} "
                            f"max|diff| {v} > {TOL[dtype][k]}")
                if dtype == "float32":
                    worst["float32"] = max(worst["float32"], *errs.values())
                else:
                    worst["bfloat16_ys"] = max(worst["bfloat16_ys"],
                                               errs["ys"])
                    worst["bfloat16"] = max(worst["bfloat16"], errs["hT"],
                                            errs["cT"])
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
        replies = [stream_client("127.0.0.1", server.port,
                                 make_audio(s, d), block=block)
                   for s, d in conns]
        launches = lstm_cuda.launches.value
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

    if launches != 9 * steps:
        raise AssertionError(f"K1 launched {launches} times for {steps} "
                             f"chunk steps (expected {9 * steps})")
    ms = np.concatenate([rec["ms"][1:] for rec in sessions])
    rtf = [rec["loc"].rtf for rec in sessions]
    log(f"  K1 launches {launches} = 9 x {steps} chunk steps")
    log(f"  model step ms (warm, synchronized): mean {ms.mean():.3f} "
        f"p90 {np.percentile(ms, 90):.3f} over {ms.size} steps; RTF per "
        f"connection {', '.join(f'{r:.4f}' for r in rtf)}")
    return launches, steps, float(ms.mean()), float(np.percentile(ms, 90))


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


def phase_times(device):
    from fnssl_tpu_torch.kernels import lstm_cuda

    rows = []
    for name, t, b, h, i in SHAPES:
        row = {"shape": name, "T": t, "B": b, "H": h}
        for dtype in ("float32", "bfloat16"):
            args = lstm_inputs(t, b, h, getattr(torch, dtype), device, 7)
            row[f"ms_{dtype}"] = cuda_ms(
                lambda: lstm_cuda.lstm_fwd(*args), 20)
            row[f"bound_terms_{dtype}"] = bound_terms(
                t, b, h, 4 if dtype == "float32" else 2)
            row[f"bound_ms_{dtype}"], row[f"bound_by_{dtype}"] = bound(
                row[f"bound_terms_{dtype}"])
        args = lstm_inputs(t, b, h, torch.float32, device, 7)
        row["plain_ms"] = cuda_ms(lambda: lstm_cuda.lstm_fwd_plain(*args), 3)
        ref = torch.nn.LSTM(i, h, batch_first=True).to(device)
        with torch.no_grad():
            ref.weight_hh_l0.copy_(args[1].T)
        x = torch.randn(b, t, i, device=device)
        state = (args[2][None], args[3][None])
        with torch.no_grad():
            row["library_ms"] = cuda_ms(lambda: ref(x, state), 20)
        rows.append(row)
        log(f"  K1 {name:20s} T={t:3d} B={b:3d} H={h:3d}: fp32 "
            f"{row['ms_float32']:.4f} ms (bound {row['bound_ms_float32']:.5f}"
            f" ms, {row['bound_by_float32']}), bf16 "
            f"{row['ms_bfloat16']:.4f} ms (bound "
            f"{row['bound_ms_bfloat16']:.5f} ms), plain {row['plain_ms']:.3f}"
            f" ms, nn.LSTM(cuDNN, I={i}) {row['library_ms']:.4f} ms")
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
    reports = cuda_build.build(["lstm_fwd"])
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions
    log("[kernels] K1 lstm_fwd against lstm_fwd_plain on the card")
    worst = phase_kernels(device)

    # 4. serve
    log("[serve] cli serve --model fnssl on the card, 3 TCP connections")
    launches, steps, step_ms, step_p90 = phase_serve(args.seed, device)

    # 5. times
    log("[times] K1 at the main path's shapes")
    rows = phase_times(device)

    # the kernel's work in one online chunk step: 9 launches, fp32
    serve = [(PER_CHUNK[r["shape"]], r) for r in rows
             if r["shape"] in PER_CHUNK]
    per_chunk = {k: sum(n * r[k] for n, r in serve)
                 for k in ("ms_float32", "plain_ms", "library_ms")}
    bound_ms, bound_by = bound(
        {k: sum(n * r["bound_terms_float32"][k] for n, r in serve)
         for k in ("bytes", "operations")})
    kernels = [{
        "name": "lstm_fwd", "route": "cuda",
        "source": "fnssl_tpu_torch/kernels/csrc/lstm_fwd.cu",
        "replaces": "fnssl_tpu/kernels/lstm_pallas.py:50",
        "launches": launches,
        "max_abs_err": worst["float32"],
        "ms": per_chunk["ms_float32"],
        "plain_ms": per_chunk["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": per_chunk["library_ms"],
        "work": "the 9 recurrences of one online chunk step, fp32",
        "chunk_steps": steps, "model_step_ms_mean": step_ms,
        "model_step_ms_p90": step_p90,
        "max_abs_err_bf16_ys": worst["bfloat16_ys"],
        "per_shape": rows,
    }]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kind": kind, "kernels": kernels}, indent=1))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
