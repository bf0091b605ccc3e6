#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (fnssl_tpu_torch) on one GPU.

  python3 chip_smoke.py [--seed N] [--out DIR]

Phases, each fatal on failure (exit code != 0, no result line):
  1. device  — the card's name and power limit (nvidia-smi); no CUDA, no run.
  2. build   — nvcc builds every kernel from the sources in the checkout
               (lstm_cluster.cu, lstm_wave.cu, lstm_wide.cu,
               lstm_bwd_cluster.cu, lstm_bwd_wave.cu, lstm_bwd_wide.cu,
               ssm_scan.cu), one nvcc per source, all started together.
  3. kernels — each kernel against its plain PyTorch version on the card:
               K1 through lstm_fwd (both directions) and lstm_fwd_bidir,
               each call on the kernel lstm_cuda.fwd_route gives its shape
               (lstm_cluster.cu, lstm_wave.cu from the rule's rows at H =
               256, lstm_wide.cu above H = 256), with exact launches, at
               the main path's shapes, at the 16-slot tick's (FN-SSL's and
               IPDnet's, phase 24) and at edge cases (B 1/11/13/17, T
               0/1/2/7, H 32/64/128/256), fp32 and bf16, nonzero h0/c0;
               lstm_wide.cu at (5, 13, 512); an LSTM of H 48, padded to 64
               (lstm_cluster.cu). lstm_wave.cu also
               at FN-SSL's narrow band in training (298, 4096, 256), in
               the 16-slot tick (12, 4096, 256) and in a DP rank's step
               (298, 2048, 256), at ragged B on both sides of each of the
               rule's thresholds, forced onto it at its own edge cases (B
               1/13/300, T 0/1/2/7, H 32-256) and with every plan it is
               built for.
  4. serve   — `cli serve --model fnssl` at full width (fresh weights from
               --seed) on cuda:0 answers 3 TCP connections of 3 s of 2-channel
               16 kHz audio; launch counts (6 of lstm_cluster.cu a chunk
               step, none of the other kernels), eof counts, and
               agreement with the same pipeline on the CPU (plain versions)
               are checked.
  5. times   — each kernel at the main path's shapes (CUDA events, warm):
               the kernel the rule gives each shape, and each of
               lstm_cluster.cu and lstm_wave.cu, one direction
               and, at full band, both in one launch; the plain version;
               the bound; and torch.nn.LSTM (cuDNN, one- and
               bidirectional, TF32 off, the port's float32, and on) as the
               library yardstick (the port never calls it). Then every
               cluster plan (N, Bt, KS) that fits at FN-SSL's and IPDnet's
               serve shapes. Then lstm_wave.cu at FN-SSL's narrow band in
               training and in the 16-slot tick beside lstm_cluster.cu,
               the bound and cuDNN (TF32 off and on), the
               card's time from a trace (fails unless lstm_wave.cu is the
               faster of the two there; also at a DP rank's narrow band,
               (298, 2048, 256)); and the sweep that sets the
               rule: lstm_wave.cu against lstm_cluster.cu at B
               256-4768 x H 128/256 x 1-2 directions x fp32/bf16 x T
               12/298 (fails where the rule routes a point to lstm_wave.cu
               that measured slower).
  6. backward — K2 against its plain version through lstm_bwd (both
               walks) and lstm_bwd_bidir, each call on the kernel
               lstm_cuda.bwd_route gives its shape (lstm_bwd_cluster.cu, or
               lstm_bwd_wave.cu from the rule's rows at H = 256), with exact
               launches: dgates, dh0, dc0 at the two training shapes, at the
               shapes of one rank's step in phase 29 (8 scenes: full band B
               2384, narrow band B 2048) and at edge cases (B 1/11/13/17, T
               1/2/7, H 32/64/128/256), fp32 and bf16, nonzero c0/dhT/dcT;
               lstm_bwd_wave.cu also through the rule at B on both sides of
               each threshold, forced onto it at the training and rank
               shapes, at its edge cases (B 1/11/13/17 and one row past a
               tile, T 1/2/7, H 32/64/128/256) and with every plan it is
               built for; lstm_bwd_wide.cu (H above 256) through the rule
               at FN-SSL's hidden-512 narrow band (298, 4096, 512), at H
               288/384/512/768/1024 at B 1/11/13/17 and one row past its
               largest tile, T 1/2/7, and with every plan at H
               288/512/544/1024 (T 7, B 77); H 48 padded to 64; and K1 at
               the training and rank shapes (FN-SSL's at hidden 512 too),
               which phase 3 never reaches, with lstm_wide.cu (H above 256)
               also at H 288/384/512/768/1024 at B 1/11/13/17 and one row
               past its largest tile, T 0/1/2/7, and with every tile at H
               288/512/544/1024 (T 7, B 77). Then the refusals: K1 and K2
               at H 1056, K3 and K4 at d_state 72 raise and launch
               nothing.
  7. train parity — one make_train_step step (fp32, dropout off, nb=2 x
               4.79 s, full width, weights from --seed) on cuda:0 and on the
               CPU: loss, every gradient and every parameter after the Adam
               step; exactly 6 K1 and 6 K2 launches a step, each as its
               rule splits it (lstm_cluster.cu and lstm_bwd_cluster.cu at
               nb=2).
  8. train   — the reference cell (nb=16 x 4.79 s, FNSSLConfig(), Adam
               1e-3 / gamma 0.8988, dropout on from a seeded generator), fp32
               then the bf16 policy: 1 warm and 5 timed steps each; ms per
               step, T-F frames/s, peak memory, finite losses, launches (3
               K1 of lstm_cluster.cu and 3 of lstm_wave.cu, 3 K2 of
               lstm_bwd_cluster.cu and 3 of lstm_bwd_wave.cu a step, as the
               rules give them).
  9. train times — at the two training shapes (CUDA events, warm): K1 and
               cuDNN forward; K2's two sources in turns (lstm_bwd_cluster.cu,
               lstm_bwd_wave.cu, lstm_bwd_wave.cu, lstm_bwd_cluster.cu) and
               the kernel bwd_route gives the shape, each the card's time
               from a trace, its bound and plain version; the port's whole
               LSTM backward and cuDNN's (forward+backward less forward, TF32
               off and on). Fails unless lstm_bwd_wave.cu is the faster of
               the two at (298, 4096, 256) fp32. Then every plan (N, Bt, KS,
               UPT) of lstm_bwd_cluster.cu that fits, fp32 and bf16; and the
               sweep that sets bwd_route's rule: lstm_bwd_wave.cu against
               lstm_bwd_cluster.cu at T 298, B 1024-4768 x H 128/256 x 1-2
               directions x fp32/bf16 (fails where the rule routes a point
               to lstm_bwd_wave.cu that measured slower). Then K1 and K2 at
               FN-SSL's hidden-512 shapes, (298, 4096, 512) and (256, 4768,
               256, both), and at K1's small-B check case (5, 13, 512),
               each on its rule's kernel: the card's time from a trace,
               the bound, the plain version, cuDNN's forward and backward
               (fp32 with TF32 off and on, bf16) and the port's whole LSTM
               backward.
 10. fit     — the user's loop through the CLI (`main()` in this process)
               on cuda:0 at full width: `simulate` 96 train scenes
               (wav+pickle) and 8 dev scenes (compact npz) of 4.79 s;
               `fit --model fnssl --bz 16 --epochs 2` (6 steps an epoch),
               `test`, `test --best`, then `serve` from the fit's
               best_model.tar (one TCP connection); `fit --model fnssl_doa
               --epochs 1 --train-size 32` and `test`. Checked: the native
               ISM ran, finite losses, each test loss equal to the valid
               loss of the epoch it restored (1e-6), the checkpoint files,
               finite ACC/MAE, exact launch counts (6 K1 and 6 K2 a train
               step, 6 K1 and no K2 an eval batch or a test batch, K1 split
               between lstm_cluster.cu and lstm_wave.cu as the rule gives
               the batch's shapes, K2 between lstm_bwd_cluster.cu and
               lstm_bwd_wave.cu as bwd_route gives them; 6 K1 of
               lstm_cluster.cu a serve chunk step; none of lstm_wide.cu).
               Printed: the simulate seconds a scene and its engine, train
               seconds, the wait for the first batch and the loader wait
               after it a fit epoch, ms a train step after the warm epoch's
               first batch against phase 8's synthetic step, each host
               stage of one batch, peak memory.
 11. ipdnet kernels — K1 (both entry points) and K2 against their plain
               versions, fp32 and bf16, at every IPDnet shape: training
               (full-band H 64 B 4480 both directions, narrow-band H 128 B
               4096, offline narrow-band H 64 both directions, the variable
               cell's B 13440 and 12288), the serve chunk step and the
               offline model's 312-frame chunked test.
 12. plans   — every lstm_cluster plan at IPDnet's training shapes and
               FN-SSL's full band (its narrow band runs on lstm_wave.cu)
               and every lstm_bwd_cluster plan at IPDnet's, fp32
               and bf16; each rule's pick against the fastest, both
               families.
 13. ipdnet serve — `cli serve --model ipdnet` (IPDnetConfig(), weights
               from --seed) on cuda:0, 3 TCP connections as phase 4: 4
               lstm_cluster launches a chunk step, outputs within 1e-3 of
               the CPU, equal DOAs per track but at exact ties, eof.
 14. ipdnet times and parity — K1/K2, plain and cuDNN at IPDnet's shapes
               (as phases 5 and 9); one fp32 train step of make_ipdnet_task
               and make_ipdnet_offline_task (nb=1 x 4.5 s) and of
               make_variable_ipdnet_task (nch 4, nb 1), dropout off, the
               card against the CPU at phase 7's tolerances, the CPU step
               taking the card's ReLU gates in the conv head.
 15. ipdnet train — the JAX package's cells (bench.py:179-265): ipdnet at
               nb=16 x 4.5 s and variable_ipdnet at nch 4, nb 8, Adam 5e-4
               / gamma 0.975, dropout on, fp32 then bf16: ms a step (mean,
               p90 of 5), peak memory, launches (4 K1 + 4 K2 a step), the
               variable forward; one fp32 ipdnet step under torch.profiler
               (busy time by kernel group, idle share).
 16. ipdnet fit — `simulate --preset ipdnet` (64 train scenes of 1 or 2
               sources, 8 dev; 16 + 8 of 1 source), fit ipdnet 2 epochs at
               bz 16, test, test --best, serve its best_model.tar; fit +
               test ipdnet_offline (the test scores the chunked inference:
               8 K1 a test batch) and variable_ipdnet, 1 epoch each. Test
               loss = the restored epoch's valid loss (1e-6), finite
               ACC/MAE, exact launches.
 17. ipdnet2 kernels — the fused selective scan, K3 and K4
               (ssm_scan.cu: x, dt, dt_bias, A, B, C, D, h0 in; y, h_last
               out, and every gradient back), against their plain versions
               at every scan shape of the IPDnet2 paths (training B 256 at
               L 201 and 40, the forward cell's L 200, serve B 16 at L 5
               and 1, the 16-slot tick's B 256 at L 5 and 1, one rank's
               step in phase 29 at B 128 and in phase 30 at B 64, L 201 and
               40, d 192) and edge cases (B 1/3/13, L 0/1/2/7, d 13/32/192),
               fp32 and bf16 inputs, one channel past the softplus
               threshold; the same at d_state 8, 32 and 64 (the kernels'
               other builds) and 24 (padded to 32), at layer 0's training
               shape and the edge cases.
 18. ipdnet2 serve — `cli serve --model ipdnet2` (SpatialNetConfig(),
               weights from --seed) on cuda:0, 3 TCP connections of 3 s of
               5-channel audio with fixed inter-mic delays: 16 K3 launches
               a chunk step and no K4, outputs within 1e-3 of the CPU,
               equal DOAs per track but at exact ties, eof.
 19. ipdnet2 times and parity — K3 and K4 a launch at each scan shape
               (fp32 and bf16 inputs; the card's time from a device trace,
               beside the host's enqueue), their bound (bytes, float32
               operations or exponentials on the SFU) and plain versions; the
               task's preprocess on the card against the CPU (features
               1e-5, targets 1e-4), then one fp32 train step (nb=2 x 4 s,
               AdamW with a clip of 5) on the card against the CPU at
               phase 7's tolerances, the CPU step taking the card's PReLU
               gates (as phase 14 its ReLU gates), with 16 K3 + 16 K4
               launches.
 20. ipdnet2 train — the JAX package's cells bench.py:138-176 (nb 16 x 4
               s, fp32 then bf16: ms a step, mean and p90 of 5, seconds of
               audio a second, peak memory, launches) and bench.py:460-481
               (the forward at nb 16, nt 200); one fp32 step under
               torch.profiler (busy time by group, idle share).
 21. ipdnet2 fit — a RealMAN-layout corpus written as wav (16 + 8
               recordings of 6 s), `fit --model ipdnet2` 2 epochs at bz 8,
               `test`, `test --best` (each test loss equal to the restored
               epoch's valid loss: the same items and seed), `serve` from
               its best_model.tar; exact launches.
 22. predict — `cli predict` of fnssl, fnssl_doa, ipdnet and ipdnet2 on a 5
               s wav (5 channels for IPDnet2; fresh weights from --seed):
               exact launches (6 K1, 6, 4 K1, 16 K3 a forward: B = 1 over
               the whole wav), the output within 1e-3 of the same weights'
               plain run on the CPU, the dumped DOAs equal to the CPU's
               decode but at exact ties; and ipd_baseline (host only).
 23. stream  — `cli stream` of each causal model (192 ms pushes): exact
               launches, the RTF, each chunk's DOA and VAD equal to the
               serve path's session on the same pushes.
 24. slots   — `cli serve --slots 16` of fnssl, ipdnet and ipdnet2: the
               pool captures tiers 1, 4 and 16 as CUDA graphs; 16
               concurrent TCP connections (3 s: 15 chunk steps each, 30 for
               IPDnet2), each held against a dedicated stream of its audio
               on the card (outputs 1e-3, DOAs but at exact ties); the
               live run traced by torch.profiler: no wrapper launches (each
               tick a graph replay), and the K1/K3 kernels in the trace
               equal each tier's traced replay x its replays; a replay of
               each tier equal to the tier run eagerly (1e-6), both running
               one chunk step's kernels;
               the ms a tick per tier, ticks, mean occupancy, aggregate
               chunk steps a second, RTF per connection. Each tier's K1
               kernels as the rule splits its shapes (FN-SSL's tier 16
               runs its narrow band on lstm_wave.cu). Then K1 and K3 at
               the 16-slot tier's shapes (as phases 5 and 19).
 25. export  — `cli export --platforms cuda`: forward and stream artifacts
               of fnssl, ipdnet and ipdnet2 and a forward artifact of
               variable_ipdnet, each loaded without model code and held
               against its module (forward 1e-5; stream chunk by chunk
               against the one-shot forward, 1e-4) with the module's
               launches; the fnssl stream artifact is exported for cuda
               and cpu, its CPU program held against the card's (1e-3);
               one `serve --artifact` TCP connection against a dedicated
               stream.
 26. locata  — a synthetic LOCATA tree (task 3 and 5, recording 1,
               dicit: 15 channels of 12 s at 48 kHz, pose, time, source and
               VAD files; written before phase 3, which holds K1 at its
               frame count too): `cli locata --model fnssl` from phase 10's
               best_model.tar on the card (exactly 6 K1 launches a
               recording, nothing else; the npy dumps; `--plot`'s figure,
               or its refusal where matplotlib is not installed), the same
               command with `--platform cpu` (the same metrics, the est
               dumps within 1e-3 degrees but at exact decode ties, every
               recording's raw output within 1e-3) and
               `locata --model ipd_baseline`; then K1 at the locata shapes
               (as phase 5).
 27. time modules — IPDnet2 with attention mhsa(251) (rope False and
               ALiBi) and ret(2) (rope False and True) at SpatialNetConfig's
               width: the forward at nb 16, nt 200 against the CPU (1e-3),
               ms (mean, p90 of 5) and peak memory; 5-frame chunks over 40
               frames against the one-shot forward (2e-4 mhsa, 2e-2 ret);
               one train step of make_ipdnet2_task(cfg) against the CPU
               (phase 19's tolerances and gates); the train cell (nb 16 x 4
               s) beside phase 20's Mamba step; no kernel launched; then
               retention's chunkwise and parallel modes alone at layer 0's
               shape (B 256, T 201, H 96, 4 heads).
 28. fit flags — `fit --model fnssl` on phase 10's corpus, 1
               epoch at bz 16: plain, `--profile 1` (the trace exists and
               names every K1 and K2 kernel a step launches) and
               `--debug-nans` (finite losses, ms a step beside the plain
               fit's); exact launches.
 29. data parallelism — `fit --use-mesh --profile 1` on the same epoch,
               a NCCL world of one in this process: its history against
               phase 28's plain fit (1e-6), exact launches, and NCCL's
               all-reduce in the trace (one a train step at least, host
               records or kernels); then two ranks on the
               one card through
               parallel.distributed with gloo (NCCL refuses two ranks on
               one device), each a process of its own (this script with
               --dp-rank), 3 DDP steps of FN-SSL (K1, K2) and of IPDnet2
               (AdamW, clip 5; K3, K4) at full width, 8 scenes a rank,
               dropout off, against 3 steps in this process on all 16:
               world-mean losses 1e-6 relative and the first step's
               gradients 1e-5 of their largest (the CPU test's), the
               parameters lr/10, the ranks' losses equal, exact
               launches a rank; ms a step of each beside the plain
               one's. NCCL runs a one-rank all-reduce without a kernel:
               the trace holds its host records (nccl:all_reduce).
 30. frequency parallelism — IPDnet2 over a 2-D (data x freq) mesh
               (parallel.make_mesh_2d, SpatialNet(freq_mesh=...),
               make_ipdnet2_task(feats_sharding=mesh), make_train_step(...,
               mesh=mesh)). A NCCL world of one in this process, a 1 x 1
               mesh: one step of phase 20's cell equal to the plain task's
               (loss and gradients 1e-6 relative), 16 K3 and 16 K4
               launches. Then four ranks on the one card as a 2 x 2 mesh
               (gloo), each a process of its own (this script with
               --fp-rank), 3 AdamW steps (clip 5) at full width on its 8
               scenes x 128 bins of phase 29's global batch, against phase
               29's 3 IPDnet2 steps in one process on all 16: world-mean
               losses 1e-6 relative and equal on the ranks, the first
               step's gradients 1e-5 of their largest, the parameters
               lr/10, exactly 48 K3 and 48 K4 launches a rank; ms a step
               of a rank beside the one process's, and the bytes the freq
               collectives moved a step. Phase 17 holds K3 and K4 at a
               rank's scan shapes (B 64 at L 201 and 40) and this phase
               times them there.
 31. fnssl hidden 512 — FNSSLConfig(hidden_size=512), every other width
               published (narrow-band LSTMs of H 512, full-band BiLSTMs of
               H 256): one fp32 train step (nb 1 x 2 s, dropout off) on the
               card against the CPU at phase 7's tolerances (3 K1 of
               lstm_cluster.cu and 3 of lstm_wide.cu, 3 K2 of
               lstm_bwd_cluster.cu and 3 of lstm_bwd_wide.cu); the cell nb
               16 x 4.79 s, fp32 then bf16, 1 warm + 3 timed steps (ms mean
               and p90, peak memory, exactly 3 K1 of lstm_wide.cu and 3 of
               lstm_wave.cu, 3 K2 of lstm_bwd_wide.cu and 3 of
               lstm_bwd_wave.cu a step) and one traced step of each (K1's
               and K2's device ms, lstm_bwd_wide.cu's alone, busy time,
               idle share).
 32. ipdnet2 mamba(32,4) — SpatialNetConfig(attention="mamba(32,4)"),
               every other width published (the fused scan at d_state 32):
               phase 19's fp32 parity step at its tolerances and gates (16
               K3 and 16 K4 launches); phase 20's cell nb 16 x 4 s, fp32
               then bf16, 1 warm + 3 timed steps (ms mean and p90, peak
               memory, exact launches); K3 and K4 a launch at its scan
               shapes beside their bounds and plain versions.
 33. time-module serving — IPDnet2 with attention="mhsa(251)" (ALiBi) and
               "ret(2)" (rotary), every width published, weights from
               --seed: forward and stream artifacts exported for cuda and
               loaded on the card against the module (1e-5; the stream
               artifact chunk by chunk against the module's chunk steps,
               and against the one-shot forward at STREAM_TOL), one `serve
               --artifact` TCP connection against a dedicated stream
               (1e-3); a 16-slot BatchedStreamPool from `_resolve` (one
               position a row) with tiers 1, 4 and 16 captured as CUDA
               graphs, 17 streams joining on different ticks, idling, and
               one re-leasing a released slot, each against a dedicated
               stream (1e-3), no wrapper launch in the live ticks, each
               tier's replay against its eager run (1e-6); export and
               capture seconds, ms a call and a tick, chunk steps a second
               of 16 streams.
The line before the last is the kernels JSON line (each kernel's numbers
over one train step's work, its launches over every path); the last line
is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
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
# a serve connection's audio (phases 4, 13, 18): 15 chunk steps of FN-SSL
SERVE_CONN_S = 3.0
FS = 16000
# (name, T, B, H, I, ndir): the recurrences of one chunk step of the serve
# path (nb=1, P=1, 12 frames, nf=256) and of a one-shot 4.79 s forward
# (nt=298); ndir 2 = a BiLSTM, both directions in one launch
SHAPES = [("serve_fullband", 256, 12, 128, 256, 2),
          ("serve_narrowband", 12, 256, 256, 256, 1),
          ("oneshot_fullband", 256, 298, 128, 256, 2),
          ("oneshot_narrowband", 298, 256, 256, 256, 1)]
# recurrences of each shape in one online chunk step (3 FN blocks): a
# BiLSTM over frequency (both directions in one launch of the cluster
# kernel) and a one-direction LSTM over time
PER_CHUNK = {"serve_fullband": 3, "serve_narrowband": 3}
LAUNCHES_PER_CHUNK = 6
# launches a serve chunk step by model, in COUNTED's order: K1 for FN-SSL's
# 3 blocks and IPDnet's 2; K3 for IPDnet2's 8 layers x 2 Mamba blocks
CHUNK_LAUNCHES = {"fnssl": [LAUNCHES_PER_CHUNK, 0, 0, 0, 0, 0, 0, 0],
                  "ipdnet": [4, 0, 0, 0, 0, 0, 0, 0],
                  "ipdnet2": [0, 0, 0, 0, 16, 0, 0, 0]}
SERVE_NCH = {"ipdnet2": 5}              # channels a connection, else 2
EDGE_B, EDGE_T, EDGE_H = (1, 11, 13, 17), (0, 1, 2, 7), (32, 64, 128, 256)
V2_CASE = (5, 13, 512)                  # (T, B, H): K1 above H = 256, small B
# training: the JAX package's reference cell (bench.py:96-135), nb scenes
# of 4.79 s (298 frames, 256 bins); the parity step runs nb=2
TRAIN_NB, TRAIN_T_S, PARITY_NB, TIMED_STEPS = 16, 4.79, 2, 5
# (name, T, B, H, I, ndir): the recurrences of one train step at nb=16: a
# BiLSTM over frequency (B = nb*nt) and an LSTM over time (B = nb*nf)
TRAIN_SHAPES = [("train_fullband", 256, 16 * 298, 128, 256, 2),
                ("train_narrowband", 298, 16 * 256, 256, 256, 1)]
PER_TRAIN_STEP = 3                      # launches of each shape a step
LAUNCHES_PER_TRAIN_STEP = 6             # K1, and K2, each
BWD_EDGE_T = (1, 2, 7)
# phase 10, the user's loop through the CLI: scenes of TRAIN_T_S seconds,
# bz 16, 2 epochs of fnssl (6 steps each, so that the loop reaches its
# steady state after the first batch, and few enough for the script's time
# limit: phases 28 and 29 take epochs of the same corpus) and 1 of
# fnssl_doa on the first FIT_DOA_TRAIN scenes
FIT_TRAIN, FIT_DEV, FIT_BZ, FIT_EPOCHS, FIT_DOA_TRAIN = 96, 8, 16, 2, 32
BWD_TOL = 1e-4                          # K2 vs plain, fp32 and bf16
STARTED = time.perf_counter()


def log(msg):
    """Print a line; a phase's header ("[name] ...") with the seconds since
    the script started."""
    if msg.startswith("["):
        msg = f"{msg} (at {time.perf_counter() - STARTED:.1f} s)"
    print(msg, flush=True)


def lstm_inputs(t_steps, batch, hidden, dtype, device, seed, ndir=None):
    """Recurrence inputs (xg, w_hh_t, h0, c0), drawn on the device (the
    training shapes hold GBs); with ndir, stacked (ndir, ...) for
    lstm_fwd_bidir."""
    lead = () if ndir is None else (ndir,)
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*lead, *shape, generator=g, device=device)

    return (randn(t_steps, batch, 4 * hidden).to(dtype),
            (randn(hidden, 4 * hidden) / hidden ** 0.5).to(dtype),
            randn(batch, hidden) * 0.5, randn(batch, hidden) * 0.5)


def max_abs_diff(got, want, rows=1 << 16):
    """max |got - want| over blocks of `rows` rows of the last dim: at FN-SSL's
    hidden-512 narrow band both directions' dgates hold 18.6 GiB, and their
    whole difference would not fit beside them."""
    if not got.numel():
        return 0.0
    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(g.split(rows), w.split(rows)))


def held(kernel, what, dtype, got, want, worst):
    """Max |kernel - plain| of ys, hT, cT against TOL; folds them into
    worst[kernel]."""
    torch.cuda.synchronize()
    errs = {k: max_abs_diff(g, w)
            for k, g, w in zip(("ys", "hT", "cT"), got, want)}
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


def k1_checks(name, t, b, h, dtype, device, seed, worst, route=None,
              plan=None):
    """K1 through lstm_fwd (both walks) and lstm_fwd_bidir against the
    plain versions at one shape, each call on the kernel fwd_route gives
    it (or on `route`, with `plan`), with exact launches; folded into
    worst[kernel]. Returns each call's errors and the kernels that ran."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    itemsize = getattr(torch, dtype).itemsize
    both = lstm_inputs(t, b, h, getattr(torch, dtype), device, seed, ndir=2)
    errs, kernels = [], []
    for ndir, calls in ((1, (False, True)), (2, (None,))):
        kernel, counter, per = k1_route(t, b, h, ndir, itemsize, route)
        kernels.append(kernel)
        for reverse in calls:
            if reverse is None:
                got = counted(counter, per, L.lstm_fwd_bidir, *both,
                              route=route, plan=plan)
                want = L.lstm_fwd_bidir_plain(*both)
                what = f"{name} lstm_fwd_bidir"
            else:
                one = tuple(a[int(reverse)] for a in both)
                got = counted(counter, per, L.lstm_fwd, *one,
                              reverse=reverse, route=route, plan=plan)
                want = L.lstm_fwd_plain(*one, reverse=reverse)
                what = f"{name} lstm_fwd reverse={int(reverse)}"
            errs.append(held(kernel, f"{what} T={t} B={b} H={h}", dtype, got,
                             want, worst))
    return errs, kernels


def phase_kernels(device, extra=()):
    """K1 against its plain version on the card, at the serve, one-shot,
    16-slot tick and `extra` shapes and the edge cases, each call on the
    kernel fwd_route gives it; then lstm_wave.cu (`wave_checks`). Returns
    the worst errors by kernel and dtype."""
    worst = {k: {"float32": 0.0, "bfloat16": 0.0, "bfloat16_ys": 0.0}
             for k in ("lstm_cluster", "lstm_wave", "lstm_wide")}
    cases = [(n, t, b, h) for n, t, b, h, _, _ in
             SHAPES + SLOT_SHAPES + list(extra)]
    cases += [("edge", t, b, h) for h in EDGE_H for b in EDGE_B
              for t in EDGE_T]
    cases += [("v2_h512", *V2_CASE), ("padded_h48", 7, 13, 48)]
    seed, checks = 0, 0
    for name, t, b, h in cases:
        for dtype in ("float32", "bfloat16"):
            seed += 1
            errs, kernels = k1_checks(name, t, b, h, dtype, device, seed,
                                      worst)
            checks += 3
            if name != "edge":
                log(f"  {'/'.join(kernels)} {name:18s} T={t:4d} B={b:4d} "
                    f"H={h:3d} {dtype:8s} max|diff| fwd/rev/bidir ys "
                    + "/".join(f"{e['ys']:.2e}" for e in errs) + " hT,cT "
                    + "/".join(f"{max(e['hT'], e['cT']):.2e}" for e in errs))
    log(f"  {checks} checks passed; edge cases B {EDGE_B} x T {EDGE_T} x "
        f"H {EDGE_H}")
    checks += wave_checks(device, worst)
    log(f"  K1: {checks} checks in all; worst {json.dumps(worst)}")
    return worst


def wave_cases():
    """(name, T, B, H) at which phase 3 holds lstm_wave.cu (through the
    rule's route): FN-SSL's narrow band in training, in the 16-slot tick
    and in a DP rank's step, and B on both sides of each threshold of
    fwd_route (ragged: not a multiple of any tile)."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    cases = [("train_narrowband", 298, TRAIN_NB * 256, 256),
             ("slots16_narrowband", 12, SLOTS * 256, 256),
             ("dp_rank_narrowband", 298, DP_NB // 2 * 256, 256)]
    for (h, itemsize), rows in sorted(L.WAVE_MIN_ROWS.items()):
        if itemsize == 4:
            cases += [(f"threshold-{d}", 7, rows + d, h) for d in (-3, 3)]
    return cases


def wave_checks(device, worst):
    """lstm_wave.cu against the plain versions: at `wave_cases` through
    the rule's route (one direction, both walks; both in one launch);
    forced onto it, at the edge cases (B 1/13/300, T 0/1/2/7, H
    32/64/128/256; at H 128 also one row past the full band's tile) and at
    every plan it is built for, at H 128 (the 128-thread tiles too) and
    256 (T 7, B 77); fp32 and bf16, nonzero h0/c0. Returns the checks."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    seed, checks = 5000, 0
    for name, t, b, h in wave_cases():
        for dtype in ("float32", "bfloat16"):
            seed += 1
            errs, kernels = k1_checks(name, t, b, h, dtype, device, seed,
                                      worst)
            checks += 3
            log(f"  {'/'.join(kernels)} {name:18s} T={t:4d} B={b:4d} "
                f"H={h:3d} {dtype:8s} plan {L.wave_plan(h, 4, b)} max|diff| "
                "fwd/rev/bidir ys " + "/".join(f"{e['ys']:.2e}" for e in errs)
                + " hT,cT " + "/".join(f"{max(e['hT'], e['cT']):.2e}"
                                       for e in errs))
    full = L.wave_plan(128, 4, TRAIN_NB * 298, 2)   # the full band's tile
    edges = [(h, b, None) for h in EDGE_H for b in (1, 13, 300)]
    edges += [(128, L.wave_tile(128, full) + 1, full)]
    for h, b, plan in edges:
        for t in EDGE_T:
            for dtype in ("float32", "bfloat16"):
                seed += 1
                k1_checks("wave edge", t, b, h, dtype, device, seed, worst,
                          route="wave", plan=plan)
                checks += 3
    plans = 0
    for h in (128, 256):
        for dtype in ("float32", "bfloat16"):
            itemsize = getattr(torch, dtype).itemsize
            both = lstm_inputs(7, 77, h, getattr(torch, dtype), device,
                               seed + h, ndir=2)
            for plan in L.WAVE_ROWS + (L.WAVE128_ROWS if h == 128 else ()):
                if not L.wave_fits(h, itemsize, plan):
                    continue
                got = counted(L.launches_wave, 1, L.lstm_fwd_bidir, *both,
                              route="wave", plan=plan)
                held("lstm_wave", f"plan {plan} H={h}", dtype, got,
                     L.lstm_fwd_bidir_plain(*both), worst)
                plans += 1
    log(f"  lstm_wave.cu: {checks} checks through fwd_route and at its edge "
        f"cases (B 1/13/300 x T {EDGE_T} x H {EDGE_H}), {plans} of its "
        f"plans; worst {json.dumps(worst['lstm_wave'])}")
    return checks + plans


def make_audio(seed, delay, nch=2, seconds=SERVE_AUDIO_S):
    """`seconds` of noise reaching mic k k·`delay` samples after mic 0,
    plus a little independent noise on each mic."""
    rng = np.random.default_rng(seed)
    n = int(seconds * FS)
    span = (nch - 1) * abs(delay)
    src = rng.standard_normal(n + span).astype(np.float32) * 0.1
    starts = [(nch - 1 - k) * delay if delay >= 0 else k * -delay
              for k in range(nch)]
    sig = np.stack([src[a: a + n] for a in starts], axis=1)
    return sig + rng.standard_normal(sig.shape).astype(np.float32) * 0.01


def serve_pipeline(model, seed, device):
    """(stream step, front-end options, decode) of `cli serve --model
    model` built directly on `device` with weights from `seed`; the decode
    returns the decoded dict and the (tracks, grid) spatial spectra."""
    from fnssl_tpu_torch.eval.decode import spatial_spectrum
    from fnssl_tpu_torch.eval.pred_doa import PredDOA, PredDOAMultiTrack
    from fnssl_tpu_torch.models.fnssl import FNSSL
    from fnssl_tpu_torch.models.ipdnet import IPDnet
    from fnssl_tpu_torch.runtime.streaming import (
        make_fnssl_stream_step, make_ipdnet_stream_step,
        make_spatialnet_stream_step)
    from fnssl_tpu_torch.train.tasks import DUALCH_MIC_LOCATION

    gen = torch.Generator().manual_seed(seed)
    if model == "ipdnet2":
        from fnssl_tpu_torch.data.arrays import audiowu_high_array_geometry
        from fnssl_tpu_torch.models.spatialnet import SpatialNet
        from fnssl_tpu_torch.train.tasks import IPDNET2_MIC_IDS

        net = SpatialNet(device=device, generator=gen).eval()
        decoder = PredDOAMultiTrack(
            audiowu_high_array_geometry()[list(IPDNET2_MIC_IDS)],
            device="cpu")
        step, front = make_spatialnet_stream_step(net), dict(
            ch_mode="none", hop=320, center=True, sample_length=249,
            frames_per_step=5)
    elif model == "ipdnet":
        net = IPDnet(device=device, generator=gen).eval()
        decoder = PredDOAMultiTrack(DUALCH_MIC_LOCATION, device="cpu")
        step, front = make_ipdnet_stream_step(net), dict(
            ch_mode="none", sample_length=280)
    if model in ("ipdnet", "ipdnet2"):
        def decode(out):
            spec = [spatial_spectrum(out[..., k], decoder.template)
                    for k in range(out.shape[-1])]
            return decoder.pred2doa(out)[0], torch.cat(spec).reshape(
                out.shape[-1], -1)

        return step, front, decode
    net = FNSSL(device=device, generator=gen).eval()
    decoder = PredDOA(device="cpu")

    def decode(out):
        res = decoder.predgt2doa(out)[0]
        return res, res["spatial_spectrum"].reshape(1, -1)

    return make_fnssl_stream_step(net), dict(ch_mode="MM"), decode


def reference_stream(seed, sig, block, model="fnssl", device="cpu"):
    """The same pipeline as a dedicated stream (its own model step, batch
    1) on `device`: through the plain versions on the CPU, the kernels on
    the card. Returns each chunk's output (on the host), decoded DOAs
    (degrees) and spectra."""
    from fnssl_tpu_torch.runtime.streaming import StreamingLocalizer

    step, front, decode = serve_pipeline(model, seed, device)
    loc = StreamingLocalizer(step, nch=sig.shape[1], device="cpu", **front)
    outs, doas, ss = [], [], []
    for start in range(0, sig.shape[0], block):
        for out in loc.push(sig[start: start + block]):
            res, spec = decode(out.cpu())
            outs.append(out.cpu())
            doas.append(np.degrees(res["doa"].numpy())[0])
            ss.append(spec.numpy())
    return outs, doas, ss


def held_lines(label, msgs, doas, spectra):
    """A server's DOA lines against a reference run's decoded DOAs
    (degrees), chunk by chunk: equal to the 3 decimals sent, or, for a
    track whose azimuth differs, an exact tie (1e-3) at the top of that
    track's spectrum. Returns the lines that sat on a tie."""
    mismatched = 0
    for msg, want, spec in zip(msgs, doas, spectra):
        got = np.asarray(msg["doa_deg"])
        if np.allclose(got, np.round(want[0], 3), atol=1e-3):
            continue
        for k in range(got.shape[-1]):
            if np.allclose(got[..., k], np.round(want[0][..., k], 3),
                           atol=1e-3):
                continue
            top2 = np.sort(spec[k])[-2:]
            if top2[1] - top2[0] > 1e-3:           # not an exact tie
                raise AssertionError(f"{label} t={msg['t']}: served "
                                     f"{msg['doa_deg']}, reference {want[0]}")
        mismatched += 1
    return mismatched


def chunk_steps(model, n=int(SERVE_AUDIO_S * FS)):
    """The chunk steps `n` samples fire: 12 frames of hop 256 a step, or
    IPDnet2's 5 frames of hop 320 after the 256-sample reflect prefix."""
    if model == "ipdnet2":
        return ((n + 256 - 512) // 320 + 1) // 5
    return ((n - 512) // 256 + 1) // 12


def phase_serve(seed, device, model="fnssl"):
    """Drive `cli serve --model model` on the card over TCP."""
    from fnssl_tpu_torch.cli.main import build_parser, build_server
    from fnssl_tpu_torch.runtime.server import stream_client

    block = 1600
    sessions = []
    per_chunk = CHUNK_LAUNCHES[model]
    nch = SERVE_NCH.get(model, 2)

    with tempfile.TemporaryDirectory() as log_dir:
        args = build_parser().parse_args(
            ["serve", "--model", model, "--port", "0", "--seed",
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
    counters = launch_counters()
    try:
        for c in counters:
            c.reset()
        replies = [stream_client("127.0.0.1", server.port,
                                 make_audio(s, d, nch, SERVE_CONN_S),
                                 block=block)
                   for s, d in conns]
        launched = [c.value for c in counters]
    finally:
        server.shutdown()

    expected_steps = chunk_steps(model, int(SERVE_CONN_S * FS))
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
        outs, doas, ss = reference_stream(
            seed, make_audio(s, d, nch, SERVE_CONN_S), block, model)
        if len(outs) != n_steps:
            raise AssertionError(f"connection {s}: CPU fired {len(outs)}")
        out_err = max((g - w).abs().max().item()
                      for g, w in zip(rec["outs"], outs))
        if not out_err <= 1e-3:
            raise AssertionError(f"connection {s}: {model} output "
                                 f"max|diff| {out_err} vs the CPU > 1e-3")
        mismatched = held_lines(f"connection {s}", msgs[:-1], doas, ss)
        azis = [m["doa_deg"][1][0] for m in msgs[:-1]]
        log(f"  connection seed={s} delay={d:+d}: {n_steps} chunk steps, "
            f"eof ok, {model} max|diff| vs CPU {out_err:.3e}, DOAs equal "
            f"(ties {mismatched}), median azimuth {np.median(azis):.1f} deg")

    # K1 through lstm_cluster.cu (K3 for IPDnet2) only; no backward while
    # serving
    want = [n * steps for n in per_chunk]
    if launched != want:
        raise AssertionError(f"serving launched {COUNTED} {launched} for "
                             f"{steps} chunk steps, expected {want}")
    ms = np.concatenate([rec["ms"][1:] for rec in sessions])
    rtf = [rec["loc"].rtf for rec in sessions]
    log(f"  launches {COUNTED} {launched} = {steps} chunk steps x "
        f"{per_chunk}")
    # one chunk step of a warm session (front end, model step, no decode)
    # under torch.profiler, outside the server
    loc, _ = make_session()
    audio = make_audio(seed, 3, nch)
    chunk = loc.frames_per_step * loc.hop
    loc.push(audio[: 2 * chunk])
    fired = []
    prof = profile_step(lambda: fired.append(
        len(loc.push(audio[2 * chunk: 3 * chunk]))))
    log(f"  profile of a push that fired {fired[0]} chunk step: wall "
        f"{prof['wall_ms']:.2f} ms, {prof['kernels']} kernels, busy "
        f"{prof['busy_ms']:.3f} ms, idle share {prof['idle_share']:.2%}")
    log(f"  model step ms (warm, synchronized): mean {ms.mean():.3f} "
        f"p90 {np.percentile(ms, 90):.3f} over {ms.size} steps; RTF per "
        f"connection {', '.join(f'{r:.4f}' for r in rtf)}")
    return dict(zip(COUNTED, launched)), steps, {
        "model_step_ms_mean": float(ms.mean()),
        "model_step_ms_p90": float(np.percentile(ms, 90)),
        "rtf_per_connection": rtf,
        "chunk_step_profile": {k: prof[k] for k in (
            "wall_ms", "busy_ms", "idle_share", "kernels")}}


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


def host_ms(fn, *args, iters=5):
    """ms of one fn(*args) call on the host's clock, synchronized (one
    warm call first, no autograd): what a caller of an artifact or a
    module waits."""
    with torch.no_grad():
        fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms(fn, iters):
    """The card's time of one fn() call: the summed durations of the device
    activity (kernels, memsets, copies) in a guarded trace
    (`guarded_trace`) of `iters` warm calls, over iters. CUDA events
    around back-to-back calls measure the host wherever its enqueue takes
    longer than the kernel (IPDnet2's serve and slot scans); these
    durations do not."""
    for _ in range(2):
        fn()

    def calls():
        for _ in range(iters):
            fn()

    _, events, _ = guarded_trace(calls, retry=lambda: None)
    us = sum(e.time_range.end - e.time_range.start for e in events)
    if not us:
        raise AssertionError("device_ms: the profiler saw no device work")
    return us / 1e3 / iters


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


# the library yardstick (nn.LSTM, cuDNN) is timed with cuDNN's TF32 off,
# the port's full float32 (what the port's order of work judges against),
# and on, PyTorch's default for cuDNN (TF32 keeps ~3 digits)
LIBRARY_TF32 = (False, True)


def library_flags(tf32):
    """The cuDNN flags the library yardstick is timed under."""
    c = torch.backends.cudnn
    return c.flags(enabled=True, benchmark=c.benchmark,
                   deterministic=c.deterministic, allow_tf32=tf32)


def library_key(key, tf32):
    """A row's key for a library time: `key` with TF32 off, key_tf32 on."""
    return f"{key}_tf32" if tf32 else key


def library_lstm(i, h, w_hh_t, bidirectional, device):
    ref = torch.nn.LSTM(i, h, batch_first=True,
                        bidirectional=bidirectional).to(device)
    with torch.no_grad():
        ref.weight_hh_l0.copy_(w_hh_t[0].T)
        if bidirectional:
            ref.weight_hh_l0_reverse.copy_(w_hh_t[1].T)
    return ref


def phase_times(device, shapes=SHAPES):
    """K1 at `shapes` (forward only): the kernel fwd_route gives each
    shape ("ms", what the path runs) and each of lstm_cluster.cu and
    lstm_wave.cu, one direction; a BiLSTM (ndir 2) also
    with both directions in one launch; the plain version, the bound and
    cuDNN with TF32 off and on."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    rows = []
    for name, t, b, h, i, ndir in shapes:
        full = ndir == 2
        row = {"shape": name, "T": t, "B": b, "H": h, "ndir": ndir,
               "route": L.fwd_route(t, b, h, 1, 4),
               "plan": L.cluster_plan(h, 4, b, ndir),
               "wave_plan": L.wave_plan(h, 4, b, ndir)}
        if full:
            row["fused_route"] = L.fwd_route(t, b, h, 2, 4)
        for dtype in ("float32", "bfloat16"):
            itemsize = 4 if dtype == "float32" else 2
            both = lstm_inputs(t, b, h, getattr(torch, dtype), device, 7,
                               ndir=2)
            one = tuple(a[0] for a in both)
            for route in ("cluster", "wave"):
                row[f"{route}_ms_{dtype}"] = cuda_ms(
                    lambda: L.lstm_fwd(*one, route=route), 20)
            row[f"ms_{dtype}"] = row[f"{row['route']}_ms_{dtype}"]
            row[f"enqueue_ms_{dtype}"] = enqueue_ms(lambda: L.lstm_fwd(*one),
                                                    20)
            terms = bound_terms(t, b, h, itemsize)
            row[f"bound_terms_{dtype}"] = terms
            row[f"bound_ms_{dtype}"], row[f"bound_by_{dtype}"] = bound(terms)
            if full:
                for route in ("cluster", "wave"):
                    row[f"fused_{route}_ms_{dtype}"] = cuda_ms(
                        lambda: L.lstm_fwd_bidir(*both, route=route), 20)
                row[f"fused_ms_{dtype}"] = row[
                    f"fused_{row['fused_route']}_ms_{dtype}"]
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
            if full:
                row["fused_plain_ms"] = cuda_ms(
                    lambda: L.lstm_fwd_bidir_plain(*both), 3)
            ref = library_lstm(i, h, both[1], False, device)
            ref2 = library_lstm(i, h, both[1], True, device) if full else None
            state = (one[2][None], one[3][None])
            for tf32 in LIBRARY_TF32:
                with library_flags(tf32):
                    row[library_key("library_ms", tf32)] = cuda_ms(
                        lambda: ref(x, state), 20)
                    if full:
                        row[library_key("library_bidir_ms", tf32)] = cuda_ms(
                            lambda: ref2(x, (both[2], both[3])), 20)
        rows.append(row)
        log(f"  K1 {name:18s} T={t:3d} B={b:4d} H={h:3d} route "
            f"{row['route']}: fp32 {row['ms_float32']:.4f} ms (enqueue "
            f"{row['enqueue_ms_float32']:.4f}, at T=1 "
            f"{row['t1_ms_float32']:.4f}), bf16 {row['ms_bfloat16']:.4f};"
            f" lstm_cluster.cu (plan (N, Bt, KS)={row['plan']}) fp32 "
            f"{row['cluster_ms_float32']:.4f}, bf16 "
            f"{row['cluster_ms_bfloat16']:.4f}; lstm_wave.cu (plan "
            f"{row['wave_plan']}) fp32 {row['wave_ms_float32']:.4f}, bf16 "
            f"{row['wave_ms_bfloat16']:.4f}; bound fp32 "
            f"{row['bound_ms_float32']:.5f} "
            f"({row['bound_by_float32']}); plain {row['plain_ms']:.3f}; "
            f"nn.LSTM (cuDNN, I={i}) TF32 off {row['library_ms']:.4f}, on "
            f"{row['library_ms_tf32']:.4f} ms")
        if full:
            log(f"  K1 {name:18s} both directions, route "
                f"{row['fused_route']}: fp32 {row['fused_ms_float32']:.4f} "
                f"ms, bf16 {row['fused_ms_bfloat16']:.4f} (lstm_cluster.cu "
                f"{row['fused_cluster_ms_float32']:.4f}, lstm_wave.cu "
                f"{row['fused_wave_ms_float32']:.4f}); bound fp32 "
                f"{row['fused_bound_ms_float32']:.5f} ms; plain "
                f"{row['fused_plain_ms']:.3f} ms; nn.LSTM bidirectional TF32 "
                f"off {row['library_bidir_ms']:.4f}, on "
                f"{row['library_bidir_ms_tf32']:.4f} ms")
    return rows


def phase_plans(device, shapes=SHAPES[:2], dtypes=("float32",), iters=20):
    """Every cluster plan that fits at `shapes` (a BiLSTM in one fused
    launch, else one direction), in each of `dtypes`."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    rows = []
    for name, t, b, h, _, ndir in shapes:
        full = ndir == 2
        for dtype in dtypes:
            tdt = getattr(torch, dtype)
            args = lstm_inputs(t, b, h, tdt, device, 7,
                               ndir=2 if full else None)
            fn = L.lstm_fwd_bidir if full else L.lstm_fwd
            default = L.cluster_plan(h, tdt.itemsize, b, ndir)
            for n in L.CLUSTER_SIZES:
                for bt in L.TILES:
                    for ks in (h // 16, h // 8):
                        try:
                            plan = L.cluster_plan(h, tdt.itemsize, b, n=n,
                                                  bt=bt, ks=ks)
                        except ValueError:
                            continue                 # does not fit
                        ms = cuda_ms(lambda: fn(*args, plan=plan,
                                                route="cluster"), iters)
                        rows.append({"shape": name, "dtype": dtype, "N": n,
                                     "Bt": bt, "KS": ks, "ms": ms,
                                     "default": plan == default})
                        log(f"  {name:18s} {dtype:8s} N={n} Bt={bt:2d} "
                            f"KS={ks:2d}: {ms:.4f} ms"
                            f"{' (default)' if plan == default else ''}")
            del args
    return rows


# phase 5's sweep of lstm_wave.cu against lstm_cluster.cu, which sets
# fwd_route's thresholds: B (a direction) x H x directions x dtype x T, and
# (T, B, H, ndir) points beside it: VariableIPDnet's narrow band (8 scenes
# x 6 mic pairs x 256 bins), the most rows any path gives H = 128
SWEEP_B, SWEEP_H, SWEEP_T = (256, 512, 1024, 2048, 4096, 4768), (128, 256), \
    (12, 298)
SWEEP_EXTRA = ((280, 12288, 128, 1),)
# the rule's margin: the wave kernels at least this much faster
WAVE_MARGIN = 0.9


def sweep_thresholds(rows):
    """By (H, itemsize), the fewest rows (B x ndir) from which the wave
    kernel measured at least 10% faster than the cluster kernel at every
    point of as many rows or more, at every T (None: nowhere)."""
    measured = {}
    for dtype in ("float32", "bfloat16"):
        for h in sorted({r["H"] for r in rows}):
            pts = [r for r in rows if r["dtype"] == dtype and r["H"] == h]
            wins = [r["B"] * r["ndir"] for r in pts if all(
                q["wave_ms"] <= WAVE_MARGIN * q["cluster_ms"] for q in pts
                if q["B"] * q["ndir"] >= r["B"] * r["ndir"])]
            measured[f"H={h} itemsize={getattr(torch, dtype).itemsize}"] = (
                min(wins) if wins else None)
    return measured


def phase_wave_sweep(device):
    """lstm_wave.cu (wave_plan's plan) against lstm_cluster.cu
    (cluster_plan's) over the sweep and SWEEP_EXTRA, CUDA events, one
    launch of ndir directions; each point's route by fwd_route beside the
    faster kernel. Fails where the rule sends a shape to lstm_wave.cu that
    measured slower there. Returns the rows and the thresholds the points
    give (`sweep_thresholds`)."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    rows, against = [], []

    def point(dtype, t, b, h, ndir):
        tdt = getattr(torch, dtype)
        args = lstm_inputs(t, b, h, tdt, device, 11,
                           ndir=2 if ndir == 2 else None)
        fn = L.lstm_fwd_bidir if ndir == 2 else L.lstm_fwd
        iters = 3 if t > 100 else 10
        ms = {r: cuda_ms(lambda: fn(*args, route=r), iters)
              for r in ("cluster", "wave")}
        del args
        route = L.fwd_route(t, b, h, ndir, tdt.itemsize)
        row = {"dtype": dtype, "T": t, "B": b, "H": h, "ndir": ndir,
               "route": route, "cluster_ms": ms["cluster"],
               "wave_ms": ms["wave"],
               "wave_plan": L.wave_plan(h, tdt.itemsize, b, ndir),
               "bound_ms": ndir * bound(bound_terms(
                   t, b, h, tdt.itemsize))[0]}
        rows.append(row)
        if route == "wave" and not ms["wave"] < ms["cluster"]:
            against.append(row)
        return row

    def line(pts):
        return " ".join(f"{r['B']}:{r['cluster_ms']:.3f}/{r['wave_ms']:.3f}"
                        f"{'*' if r['route'] == 'wave' else ''}" for r in pts)

    for dtype in ("float32", "bfloat16"):
        for h in SWEEP_H:
            for ndir in (1, 2):
                for t in SWEEP_T:
                    pts = [point(dtype, t, b, h, ndir) for b in SWEEP_B]
                    log(f"  {dtype:8s} H={h} ndir={ndir} T={t:3d} B: "
                        f"cluster/wave ms (* routed to lstm_wave.cu) "
                        + line(pts))
        for t, b, h, ndir in SWEEP_EXTRA:
            log(f"  {dtype:8s} H={h} ndir={ndir} T={t:3d} B: cluster/wave ms "
                + line([point(dtype, t, b, h, ndir)]))
    measured = sweep_thresholds(rows)
    thresholds = {f"H={h} itemsize={i}": n
                  for (h, i), n in L.WAVE_MIN_ROWS.items()}
    log(f"  {len(rows)} points; fwd_route's thresholds (rows = B x ndir) "
        f"{thresholds}; the sweep's (at least {1 - WAVE_MARGIN:.0%} faster "
        f"from these rows up) {measured}")
    if against:
        raise AssertionError(f"fwd_route sends to lstm_wave.cu shapes where "
                             f"it measured slower: {against}")
    return rows, measured


def phase_wave_times(device):
    """lstm_wave.cu at WAVE_TARGETS beside lstm_cluster.cu, the plain
    version, the bound and cuDNN (TF32 off and on), the card's
    time of a launch of ndir directions from a device trace (device_ms),
    fp32 and bf16. Fails unless fwd_route gives each target to
    lstm_wave.cu in float32, and lstm_wave.cu is the faster of it and
    lstm_cluster.cu wherever the rule gives it a target. Returns the
    rows."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    rows = []
    for name, t, b, h, ndir in WAVE_TARGETS:
        row = {"shape": name, "T": t, "B": b, "H": h, "ndir": ndir,
               "route": L.fwd_route(t, b, h, ndir, 4),
               "wave_plan": L.wave_plan(h, 4, b, ndir),
               "cluster_plan": L.cluster_plan(h, 4, b, ndir)}
        iters = 5 if t > 100 else 20
        fn = L.lstm_fwd_bidir if ndir == 2 else L.lstm_fwd
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            args = lstm_inputs(t, b, h, tdt, device, 13, ndir=ndir)
            if ndir == 1:
                args = tuple(a[0] for a in args)
            for route in ("cluster", "wave"):
                row[f"{route}_ms_{dtype}"] = device_ms(
                    lambda: fn(*args, route=route), iters)
            row[f"bound_ms_{dtype}"], row[f"bound_by_{dtype}"] = bound(
                {k: ndir * v for k, v in bound_terms(
                    t, b, h, tdt.itemsize).items()})
            if dtype == "float32":
                plain = L.lstm_fwd_bidir_plain if ndir == 2 \
                    else L.lstm_fwd_plain
                row["plain_ms"] = cuda_ms(lambda: plain(*args), 1)
                x = torch.randn(b, t, h, device=device)
                w = args[1] if ndir == 2 else args[1][None]
                ref = library_lstm(h, h, w, ndir == 2, device)
                state = tuple(a if ndir == 2 else a[None]
                              for a in args[2:])
                with torch.no_grad():
                    for tf32 in LIBRARY_TF32:
                        with library_flags(tf32):
                            row[library_key("library_ms", tf32)] = device_ms(
                                lambda: ref(x, state), iters)
                del x, ref
            del args
        rows.append(row)
        log(f"  {name:18s} T={t:3d} B={b} H={h} ndir={ndir} (device ms a "
            f"launch, from a trace): lstm_wave.cu (plan {row['wave_plan']}) "
            f"fp32 {row['wave_ms_float32']:.4f}, bf16 "
            f"{row['wave_ms_bfloat16']:.4f}; lstm_cluster.cu fp32 "
            f"{row['cluster_ms_float32']:.4f}, bf16 "
            f"{row['cluster_ms_bfloat16']:.4f}; "
            f"bound {row['bound_ms_float32']:.4f} "
            f"({row['bound_by_float32']}); plain {row['plain_ms']:.2f}; "
            f"nn.LSTM (cuDNN) TF32 off {row['library_ms']:.4f}, on "
            f"{row['library_ms_tf32']:.4f}")
        for dtype in ("float32", "bfloat16"):
            route = L.fwd_route(t, b, h, ndir, getattr(torch, dtype).itemsize)
            row[f"route_{dtype}"] = route
            if (dtype == "float32" and route != "wave") or (
                    route == "wave" and not row[f"wave_ms_{dtype}"]
                    < row[f"cluster_ms_{dtype}"]):
                raise AssertionError(f"{name} {dtype}: route {route}, "
                                     f"lstm_wave.cu "
                                     f"{row[f'wave_ms_{dtype}']} ms against "
                                     f"lstm_cluster.cu "
                                     f"{row[f'cluster_ms_{dtype}']}")
    return rows


def bwd_inputs(lead, t_steps, batch, hidden, dtype, device, seed):
    """K2's inputs (g, w_hh, c0, dys, dhT, dcT), all nonzero, drawn on the
    device; stacked `lead` directions in front."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(*lead, *shape, generator=gen, device=device)
                * scale).to(dt)

    return (randn(t_steps, batch, 4 * hidden),
            randn(4 * hidden, hidden, scale=hidden ** -0.5, dt=dtype),
            randn(batch, hidden, scale=0.5),
            randn(t_steps, batch, hidden, dt=dtype),
            randn(batch, hidden, scale=0.5), randn(batch, hidden, scale=0.5))


def held_bwd(what, got, want, worst, dtype):
    """Max |kernel - plain| of dgates, dh0, dc0 against BWD_TOL."""
    torch.cuda.synchronize()
    errs = {k: max_abs_diff(g, w)
            for k, g, w in zip(("dgates", "dh0", "dc0"), got, want)}
    for k, v in errs.items():
        if not v <= BWD_TOL:
            raise AssertionError(f"{what} {dtype}: {k} max|diff| {v} > "
                                 f"{BWD_TOL}")
    worst[dtype] = max(worst[dtype], *errs.values())
    return max(errs.values())


def k2_checks(name, t, b, h, dtype, device, seed, worst_bwd, checks,
              route=None, plan=None):
    """K2 through lstm_bwd (both walks) and lstm_bwd_bidir against the
    plain versions at one shape, each call on the kernel bwd_route gives it
    (or on `route`, with `plan`), with exact launches; folded into
    worst_bwd[kernel] and counted in checks[kernel]. Returns each call's
    largest error and the kernels that ran."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    tdt = getattr(torch, dtype)
    both = bwd_inputs((2,), t, b, h, tdt, device, seed)
    errs, kernels = [], []
    for ndir, calls in ((1, (False, True)), (2, (None,))):
        if route is None:
            kernel, counter = k2_route(t, b, h, ndir, tdt.itemsize)
        else:
            kernel = L.BWD_SOURCES[route]
            counter = L.BWD_COUNTERS[kernel]
        kernels.append(kernel)
        for reverse in calls:
            if reverse is None:
                fn, plain, args, kw = (L.lstm_bwd_bidir,
                                       L.lstm_bwd_bidir_plain, both, {})
                what = "lstm_bwd_bidir"
            else:
                fn, plain = L.lstm_bwd, L.lstm_bwd_plain
                args = tuple(a[int(reverse)] for a in both)
                kw = {"reverse": reverse}
                what = f"lstm_bwd reverse={int(reverse)}"
            got = counted(counter, 1, fn, args[0].clone(), *args[1:],
                          route=route, plan=plan, **kw)
            # the last call's plain version takes g itself: at (298, 4096,
            # 512) a copy of both directions' g is 18.6 GiB
            want = plain(args[0] if reverse is None else args[0].clone(),
                         *args[1:], **kw)
            checks[kernel] += 1
            errs.append(held_bwd(f"{kernel} {name} T={t} B={b} H={h} {what}",
                                 got, want, worst_bwd[kernel], dtype))
            del got, want
    return errs, kernels


def bwd_wave_cases(shapes):
    """(name, T, B, H, route, plan) at which phase 6 holds
    lstm_bwd_wave.cu beyond the rule's calls at `shapes`: B on both sides
    of each threshold of bwd_route (through the rule); forced onto it at
    `shapes` where the rule keeps them on lstm_bwd_cluster.cu, and at its
    edge cases (B 1/11/13/17, T 1/2/7, H 32-256; one row past the largest
    tile of each width, on that tile; one row past the full band's H = 128
    tile, on it)."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    cases = []
    for (h, itemsize), rows in sorted(L.BWD_WAVE_MIN_ROWS.items()):
        if itemsize == 4:
            cases += [(f"threshold{d:+d}", 7, rows + d, h, None, None)
                      for d in (-3, 3)]
    cases += [(n, t, b, h, "wave", None) for n, t, b, h, _, ndir in shapes
              if h <= L.CLUSTER_MAX_HIDDEN
              and L.bwd_route(t, b, h, ndir, 4) != "wave"]
    cases += [("wave edge", t, b, h, "wave", None) for h in EDGE_H
              for b in EDGE_B for t in BWD_EDGE_T]
    # one row past the largest tile of each width, on that tile
    for h in EDGE_H:
        plan = max(L.bwd_wave_plans(h, 4))
        cases += [("wave edge", t, L.bwd_wave_tile(h, plan) + 1, h, "wave",
                   plan) for t in BWD_EDGE_T]
    # one row past the H = 128 tile of FN-SSL's full band, on that tile
    full = L.bwd_wave_plan(128, 4, TRAIN_NB * 298, 2)
    cases += [("wave edge", t, full + 1, 128, "wave", full)
              for t in BWD_EDGE_T]
    return cases


def phase_backward(device, worst, shapes):
    """K2 against its plain version on the card, through lstm_bwd and
    lstm_bwd_bidir, each call on the kernel bwd_route gives it, at `shapes`
    (the training shapes and phase 29's rank shapes) and the edge cases;
    lstm_bwd_wave.cu at `bwd_wave_cases` and with every plan it is built
    for (T 7, B 77, H 128 and 256; every tile of the H = 128 kernel); and
    K1 at `shapes` (folded into
    worst). Returns K2's worst errors by source and dtype, and its checks
    by source."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    worst_bwd = {k: {"float32": 0.0, "bfloat16": 0.0}
                 for k in L.BWD_COUNTERS}
    checks = dict.fromkeys(L.BWD_COUNTERS, 0)
    cases = [(n, t, b, h, None, None) for n, t, b, h, _, _ in shapes]
    cases += [("edge", t, b, h, None, None) for h in EDGE_H for b in EDGE_B
              for t in BWD_EDGE_T]
    cases += bwd_wave_cases(shapes) + bwd_wide_cases()
    seed = 1000
    for name, t, b, h, route, plan in cases:
        for dtype in ("float32", "bfloat16"):
            seed += 1
            errs, kernels = k2_checks(name, t, b, h, dtype, device, seed,
                                      worst_bwd, checks, route, plan)
            if "edge" not in name:
                log(f"  {'/'.join(kernels)} {name:16s} T={t:3d} B={b:4d} "
                    f"H={h:3d} {dtype:8s} max|diff| dgates/dh0/dc0 "
                    "fwd/rev/bidir " + "/".join(f"{v:.2e}" for v in errs))
                torch.cuda.empty_cache()
    plans = 0
    for h in (128, 256):
        for dtype in ("float32", "bfloat16"):
            for plan in L.bwd_wave_plans(h, getattr(torch, dtype).itemsize):
                seed += 1
                k2_checks(f"plan {plan}", 7, 77, h, dtype, device, seed,
                          worst_bwd, checks, "wave", plan)
                plans += 1
    for h in WIDE_PLAN_H:
        for dtype in ("float32", "bfloat16"):
            for plan in L.bwd_wide_plans(h):
                seed += 1
                k2_checks(f"plan {plan}", 7, 77, h, dtype, device, seed,
                          worst_bwd, checks, "wide", plan)
                plans += 1
    log(f"  K2 checks passed by source {json.dumps(checks)} at "
        f"{', '.join(n for n, *_ in shapes)}, edge cases B {EDGE_B} x T "
        f"{BWD_EDGE_T} x H {EDGE_H}, lstm_bwd_wave.cu also one row past a "
        f"tile, lstm_bwd_wide.cu at H {WIDE_EDGE_H} (B {EDGE_B} and one row "
        f"past a tile), H 48 padded, {plans} plans of both; worst "
        f"{json.dumps(worst_bwd)}")
    for name, t, b, h, _, _ in shapes:
        for dtype in ("float32", "bfloat16"):
            seed += 1
            errs, kernels = k1_checks(name, t, b, h, dtype, device, seed,
                                      worst)
            log(f"  {'/'.join(kernels)} {name:16s} T={t:3d} B={b:4d} "
                f"H={h:3d} {dtype:8s} max|diff| fwd/rev/bidir ys "
                + "/".join(f"{e['ys']:.2e}" for e in errs)
                + " hT,cT " + "/".join(f"{max(e['hT'], e['cT']):.2e}"
                                       for e in errs))
    log(f"  K1 above H = 256: {wide_k1_checks(device, worst, seed)} checks "
        f"of lstm_wide.cu at H {WIDE_EDGE_H} (B {EDGE_B} and one row past "
        f"its largest tile, T {EDGE_T}) and every tile at H {WIDE_PLAN_H}; "
        f"worst {json.dumps(worst['lstm_wide'])}")
    return worst_bwd, checks


def wide_k1_checks(device, worst, seed):
    """lstm_wide.cu against the plain versions beyond the rule's calls at
    the wide training shapes: WIDE_EDGE_H at B 1/11/13/17 and one row past
    its largest tile, T 0/1/2/7, through the rule; every tile it takes at
    WIDE_PLAN_H (T 7, B 77); fp32 and bf16, nonzero h0/c0. Returns the
    checks."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    checks = 0
    for h in WIDE_EDGE_H:
        past = max(r for r in L.WIDE_ROWS if L.wide_fits(h, r)) + 1
        for b in EDGE_B + (past,):
            for t in EDGE_T:
                for dtype in ("float32", "bfloat16"):
                    seed += 1
                    k1_checks("wide edge", t, b, h, dtype, device, seed,
                              worst)
                    checks += 3
    for h in WIDE_PLAN_H:
        for plan in (r for r in L.WIDE_ROWS if L.wide_fits(h, r)):
            for dtype in ("float32", "bfloat16"):
                seed += 1
                k1_checks(f"wide plan {plan}", 7, 77, h, dtype, device, seed,
                          worst, route="wide", plan=plan)
                checks += 3
    return checks


def train_setup(seed, device, nb, precision="fp32", hidden=256,
                t_s=TRAIN_T_S):
    """(state, step, batch) of the FN-SSL reference task on `device`:
    FNSSLConfig(hidden_size=hidden) (FNSSLConfig() at 256), weights from
    `seed`, Adam 1e-3 / gamma 0.8988, nb scenes of t_s seconds."""
    from fnssl_tpu_torch.models.fnssl import FNSSL, FNSSLConfig
    from fnssl_tpu_torch.train import step as S
    from fnssl_tpu_torch.train import tasks as TK

    cfg = FNSSLConfig(hidden_size=hidden)
    model = FNSSL(cfg, device=device,
                  generator=torch.Generator().manual_seed(seed))
    tx = S.make_optimizer("adam", 1e-3, 0.8988, 1)
    step = S.make_train_step(TK.make_fnssl_task(cfg, precision=precision,
                                                device=device).loss_fn, tx)
    batch = {k: torch.as_tensor(v, device=device) for k, v in
             TK.synthetic_fnssl_batch(nb=nb, t_s=t_s, seed=seed).items()}
    return S.init_train_state(model, tx), step, batch


COUNTED = ("lstm_cluster", "lstm_wide", "lstm_bwd_wave", "lstm_bwd_cluster",
           "ssm_scan_fwd", "ssm_scan_bwd", "lstm_wave", "lstm_bwd_wide")
# their kernels' names in a device trace, in the same order
TRACED = ("lstm_cluster_kernel", "lstm_wide_kernel", "lstm_bwd_wave_kernel",
          "lstm_bwd_cluster_kernel", "selective_fwd_kernel",
          "selective_bwd_kernel", "lstm_wave_kernel", "lstm_bwd_wide_kernel")
TRACE_GUARD = 2048
# the settling time of each try of a guarded trace
TRACE_SETTLE_S = (0.1, 1.0, 2.0)


def traced_index(name):
    """The index in TRACED of the kernel that a device trace's event
    `name` ran (a kernel's H = 128 tile, `<kernel>_h128`, counts as that
    kernel), or None."""
    for i, k in enumerate(TRACED):
        if re.search(rf"\b{k}(?:_h128)?\b", name):
            return i
    return None


def launch_counters():
    """The launch counters of every kernel, in the order of COUNTED."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L
    from fnssl_tpu_torch.kernels import ssm_cuda as S

    return (L.launches, L.launches_wide, L.launches_bwd_wave,
            L.launches_bwd_cluster, S.launches_ssm_fwd, S.launches_ssm_bwd,
            L.launches_wave, L.launches_bwd_wide)


def k1_route(t_steps, batch, hidden, ndir, itemsize, route=None):
    """(name in COUNTED, launch counter, launches a call) of the K1 kernel
    that lstm_cuda.fwd_route gives a call of `ndir` directions at this
    shape (one launch a call), or of `route`."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    route = route or L.fwd_route(t_steps, batch, hidden, ndir, itemsize)
    return {"cluster": ("lstm_cluster", L.launches, 1),
            "wave": ("lstm_wave", L.launches_wave, 1),
            "wide": ("lstm_wide", L.launches_wide, 1)}[route]


def k1_split(recurrences, itemsize=4):
    """K1 launches in COUNTED's order of `recurrences`, (T, B, H, ndir, n)
    each: n calls at that shape, each on the kernel fwd_route gives it."""
    out = [0] * len(COUNTED)
    for t_steps, batch, hidden, ndir, n in recurrences:
        name, _, per = k1_route(t_steps, batch, hidden, ndir, itemsize)
        out[COUNTED.index(name)] += n * per
    return out


def k2_route(t_steps, batch, hidden, ndir, itemsize):
    """(name in COUNTED, launch counter) of the K2 kernel that
    lstm_cuda.bwd_route gives a call of `ndir` directions at this shape
    (one launch a call)."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    route = L.bwd_route(t_steps, batch, hidden, ndir, itemsize)
    name = L.BWD_SOURCES[route]
    return name, L.BWD_COUNTERS[name]


def fnssl_recurrences(nb, nt=298, hidden=256):
    """(T, B, H, ndir, n) of one FN-SSL forward (FNSSLConfig(hidden_size=
    hidden), 3 blocks, 256 bins) of nb scenes of nt frames: a full-band
    BiLSTM (T 256, B nb nt, H hidden/2) and a narrow-band LSTM (T nt, B nb
    256, H hidden) a block."""
    return [(256, nb * nt, hidden // 2, 2, 3), (nt, nb * 256, hidden, 1, 3)]


def fnssl_k1(nb, nt=298, itemsize=4, hidden=256):
    """K1 launches (COUNTED's order) of one FN-SSL forward."""
    return k1_split(fnssl_recurrences(nb, nt, hidden), itemsize)


def step_launches(nb, itemsize=4, hidden=256, nt=298):
    """Launches (COUNTED's order) of one FN-SSL train step of nb scenes of
    nt frames (4.79 s: 298): fnssl_k1's forward and a K2 launch for each
    of its 6 recurrences, on the kernel bwd_route gives it."""
    out = fnssl_k1(nb, nt, itemsize, hidden)
    for t_steps, batch, h, ndir, n in fnssl_recurrences(nb, nt, hidden):
        name, _ = k2_route(t_steps, batch, h, ndir, itemsize)
        out[COUNTED.index(name)] += n
    return out



def gate_hooks(module, names, masks, record):
    """Forward hooks on the submodules `names`, whose outputs go through a
    ReLU: with `record`, keep each output's signs (> 0) in `masks`; else
    give each output the signs kept there, straight through (the value
    moves only where a sign differs, by twice its magnitude; the gradient
    passes unchanged). Returns the handles and, filled as the hooks run,
    the count of signs changed by name."""
    changed = {}

    def hook(name):
        def fn(mod, args, out):
            if record:
                masks[name] = out > 0
                return None
            want = masks[name].to(out.device)
            changed[name] = int((want != (out > 0)).sum())
            forced = torch.where(want, out.abs(), -out.abs())
            return out + (forced - out).detach()
        return fn

    subs = dict(module.named_modules())
    return [subs[n].register_forward_hook(hook(n)) for n in names], changed


def phase_train_parity(seed, device, setup=None, lr=1e-3, want=None,
                       gates=()):
    """One fp32 train step, dropout off, on the card and on the CPU:
    `setup(device)` gives (state, step, batch), FN-SSL's at nb=PARITY_NB
    by default; Adam at `lr`; `want` launches on the card (FN-SSL's at
    PARITY_NB by default). `gates` names
    the modules whose outputs pass a ReLU: the CPU step takes the card's
    ReLU gates there (`gate_hooks`), since an output within float32
    rounding of 0 may take either side, and one gate switched moves a
    weight gradient summed over ~1e5 positions by ~1e-3 of its largest
    value, more than the summation order does; the gates switched are
    counted and printed."""
    if setup is None:
        setup = functools.partial(train_setup, seed, nb=PARITY_NB)
        want = step_launches(PARITY_NB)
    runs, masks, switched = [], {}, {}
    for k, dev in enumerate((device, torch.device("cpu"))):
        state, step, batch = setup(device=dev)
        counts = launch_counters()
        for c in counts:
            c.reset()
        handles, changed = gate_hooks(state.module, gates, masks,
                                      record=k == 0)
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        loss = float(loss)
        seconds = time.perf_counter() - t0
        for h in handles:
            h.remove()
        switched.update(changed)
        named = list(state.module.named_parameters())
        runs.append((loss, {n: p.grad.cpu() for n, p in named},
                     {n: p.detach().cpu() for n, p in named},
                     [c.value for c in counts], seconds))
        del state, step, batch, named
    (loss_c, grads_c, params_c, launched, sec_c), (
        loss_p, grads_p, params_p, plain_launched, sec_p) = runs
    if launched != want or plain_launched != [0] * len(COUNTED):
        raise AssertionError(f"train step launched {COUNTED} {launched} on "
                             f"the card, {plain_launched} on the CPU; "
                             f"expected {want} and none")
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    grad_rel = {n: ((grads_c[n] - g).abs().max() / g.abs().max()).item()
                for n, g in grads_p.items()}
    dp = {n: (params_c[n] - p).abs() for n, p in params_p.items()}
    dp_max = max(d.max().item() for d in dp.values())
    dp_moved = sum(int((d > 1e-6).sum()) for d in dp.values()) / sum(
        d.numel() for d in dp.values())
    worst_grad = max(grad_rel, key=grad_rel.get)
    log(f"  loss card {loss_c:.8f} CPU {loss_p:.8f} (rel {loss_rel:.2e}); "
        f"worst grad max|diff|/max|g| {grad_rel[worst_grad]:.2e} "
        f"({worst_grad}); params after Adam max|diff| {dp_max:.2e}, share "
        f"> 1e-6 {dp_moved:.2e}; launches {launched}; step {sec_c:.2f} s "
        f"on the card (first, with set-up), {sec_p:.2f} s on the CPU"
        + (f"; gates (ReLU, PReLU) the CPU took from the card where its own "
           f"differ: {switched}" if gates else ""))
    # tolerances: float32 recurrences of up to 298 steps summed in another
    # order (measured on an H100: loss 6e-8, gradients 2.3e-6); Adam's
    # first step moves every parameter by about lr * sign(g), so only a
    # gradient within its error of 0 can flip a parameter's step (by at
    # most 2 lr)
    if not (loss_rel <= 1e-6 and grad_rel[worst_grad] <= 1e-4
            and dp_max <= 2.1 * lr and dp_moved <= 1e-4):
        raise AssertionError("train step on the card disagrees with the "
                             "CPU beyond the stated tolerances")
    return {"loss_card": loss_c, "loss_cpu": loss_p, "loss_rel": loss_rel,
            "grad_rel_max": grad_rel[worst_grad], "grad_rel": grad_rel,
            "param_max_abs_diff": dp_max, "param_share_above_1e-6": dp_moved,
            "launches": launched, "relu_gates_switched": switched}


def phase_train(seed, device):
    """The reference cell, fp32 then bf16: 1 warm + TIMED_STEPS steps."""
    frames = TRAIN_NB * 298 * 256
    rows = {}
    counts = launch_counters()
    for c in counts:
        c.reset()
    for precision in ("fp32", "bf16"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, step, batch = train_setup(seed, device, TRAIN_NB, precision)
        gen = torch.Generator(device=device).manual_seed(seed)
        ms, losses = [], []
        for k in range(1 + TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, batch, gen)
            torch.cuda.synchronize()
            if k:
                ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        ms = np.array(ms)
        row = {"ms_mean": float(ms.mean()),
               "ms_p90": float(np.percentile(ms, 90)), "ms": ms.tolist(),
               "frames_per_s": frames / (ms.mean() / 1e3),
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "losses": losses}
        rows[precision] = row
        if not np.isfinite(losses).all():
            raise AssertionError(f"{precision} training: losses {losses}")
        log(f"  {precision}: step ms mean {row['ms_mean']:.2f} p90 "
            f"{row['ms_p90']:.2f} over {TIMED_STEPS} steps; "
            f"{row['frames_per_s']:.0f} T-F frames/s; peak "
            f"{row['peak_bytes'] / 2**30:.2f} GiB; losses "
            + ", ".join(f"{v:.6f}" for v in losses))
        del state, step, batch
    steps = 1 + TIMED_STEPS
    per = {p: step_launches(TRAIN_NB, 4 if p == "fp32" else 2)
           for p in ("fp32", "bf16")}
    launched = [c.value for c in counts]
    want = [steps * (a + b) for a, b in zip(per["fp32"], per["bf16"])]
    if launched != want:
        raise AssertionError(f"training launched {COUNTED} {launched} for "
                             f"{steps} steps of each precision, expected "
                             f"{want}")
    log(f"  launches {COUNTED} {launched} = {steps} steps x {per['fp32']} "
        f"(fp32) + {steps} x {per['bf16']} (bf16)")
    return rows, dict(zip(COUNTED, launched))


def bwd_bound_terms(t_steps, batch, hidden, itemsize):
    """The least time (ms) K2 needs for its bytes (g read, dgates written,
    dys and W_hh read, c0 dhT dcT dh0 dc0) and for its FLOPs (the step
    product dgates @ W_hh), one direction."""
    nbytes = (2 * t_steps * batch * 4 * hidden * 4
              + t_steps * batch * hidden * itemsize
              + 4 * hidden * hidden * itemsize
              + 5 * batch * hidden * 4)
    flops = 2 * batch * 4 * hidden * hidden * t_steps
    return {"bytes": nbytes / HBM_BYTES_S * 1e3,
            "operations": flops / FP32_FLOP_S * 1e3}


def lstm_grad_case(t_steps, batch, hidden, in_size, ndir, device, seed):
    """The port's LSTM with grads on, at a training shape: (params, x,
    output cotangent)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    k = hidden ** -0.5
    shapes = {"weight_ih_l0": (4 * hidden, in_size),
              "weight_hh_l0": (4 * hidden, hidden),
              "bias_ih_l0": (4 * hidden,), "bias_hh_l0": (4 * hidden,)}
    params = {n + s: ((torch.rand(shape, generator=gen, device=device) * 2
                       - 1) * k).requires_grad_()
              for s in ("", "_reverse")[:ndir] for n, shape in shapes.items()}
    x = torch.randn(batch, t_steps, in_size, generator=gen, device=device,
                    requires_grad=True)
    gy = torch.randn(batch, t_steps, ndir * hidden, generator=gen,
                     device=device)
    return params, x, gy


def phase_train_times(device, shapes=TRAIN_SHAPES, k2_turns=True):
    """K1, K2 and the whole LSTM backward at the training shapes. With
    `k2_turns`, K2's two sources in turns (lstm_bwd_cluster.cu,
    lstm_bwd_wave.cu, lstm_bwd_wave.cu, lstm_bwd_cluster.cu), each the
    card's time of a launch from a trace (device_ms); else the kernel
    bwd_route gives the shape alone, CUDA events. "k2_ms" is the kernel
    bwd_route gives the shape."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L
    from fnssl_tpu_torch.models.lstm import lstm

    rows = []
    for name, t, b, h, i, ndir in shapes:
        bidir = ndir == 2
        row = {"shape": name, "T": t, "B": b, "H": h, "I": i, "ndir": ndir,
               "k1_route": L.fwd_route(t, b, h, ndir, 4),
               "plan": L.cluster_plan(h, 4, b, ndir),
               "wave_plan": L.wave_plan(h, 4, b, ndir),
               "k2_plan": L.bwd_cluster_plan(h, 4),
               "k2_wave_plan": L.bwd_wave_plan(h, 4, b, ndir)}
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            itemsize = tdt.itemsize
            args = lstm_inputs(t, b, h, tdt, device, 7, ndir=ndir)
            k1, k1_plain = ((L.lstm_fwd_bidir, L.lstm_fwd_bidir_plain)
                            if bidir else (L.lstm_fwd, L.lstm_fwd_plain))
            if not bidir:
                args = tuple(a[0] for a in args)
            for route in ("cluster", "wave"):
                row[f"k1_{route}_ms_{dtype}"] = cuda_ms(
                    lambda: k1(*args, route=route), 5)
            row[f"k1_ms_{dtype}"] = row[f"k1_{row['k1_route']}_ms_{dtype}"]
            terms = {k: ndir * v for k, v in
                     bound_terms(t, b, h, itemsize).items()}
            row[f"k1_bound_terms_{dtype}"] = terms
            if dtype == "float32":
                row["k1_plain_ms"] = cuda_ms(lambda: k1_plain(*args), 1)
            # K2 rewrites g in place: each timed launch starts from the last
            # one's dgates, which costs the same work
            args = bwd_inputs((ndir,), t, b, h, tdt, device, 8)
            k2, k2_plain = ((L.lstm_bwd_bidir, L.lstm_bwd_bidir_plain)
                            if bidir else (L.lstm_bwd, L.lstm_bwd_plain))
            if not bidir:
                args = tuple(a[0] for a in args)
            route = L.bwd_route(t, b, h, ndir, itemsize)
            row[f"k2_route_{dtype}"] = route
            if k2_turns:
                turns = {}
                for r in ("cluster", "wave", "wave", "cluster"):
                    turns.setdefault(r, []).append(
                        device_ms(lambda: k2(*args, route=r), 3))
                for r, ms in turns.items():
                    row[f"k2_{r}_turns_{dtype}"] = ms
                    row[f"k2_{r}_ms_{dtype}"] = float(np.mean(ms))
            else:
                row[f"k2_{route}_ms_{dtype}"] = cuda_ms(lambda: k2(*args), 5)
            row[f"k2_ms_{dtype}"] = row[f"k2_{route}_ms_{dtype}"]
            row[f"k2_bound_terms_{dtype}"] = {
                k: ndir * v for k, v in bwd_bound_terms(t, b, h,
                                                        itemsize).items()}
            if dtype == "float32":
                row["k2_plain_ms"] = cuda_ms(lambda: k2_plain(*args), 1)
            del args
        # the port's whole LSTM backward (G recomputed, K2, dx, dW, db)
        params, x, gy = lstm_grad_case(t, b, h, i, ndir, device, 9)
        out, _ = lstm(params, x, None, bidir)
        row["port_bwd_ms"] = cuda_ms(lambda: torch.autograd.backward(
            [out], [gy], retain_graph=True), 3)
        row["port_fwd_ms"] = cuda_ms(lambda: lstm(params, x, None, bidir), 3)
        del out, params
        # cuDNN (the yardstick, never called by the port): forward alone
        # under no_grad, and forward+backward less forward with grads
        ref = torch.nn.LSTM(i, h, batch_first=True,
                            bidirectional=bidir).to(device)
        for tf32 in LIBRARY_TF32:
            with library_flags(tf32):
                with torch.no_grad():
                    row[library_key("library_fwd_ms", tf32)] = cuda_ms(
                        lambda: ref(x), 5)
                fwd_grad = cuda_ms(lambda: ref(x), 3)
                both = cuda_ms(lambda: torch.autograd.backward(ref(x)[0],
                                                               gy), 3)
            row[library_key("library_bwd_ms", tf32)] = both - fwd_grad
        del ref, x, gy
        torch.cuda.empty_cache()
        rows.append(row)
        log(f"  {name:16s} T={t} B={b} H={h} ndir={ndir}: K1 "
            f"({row['k1_route']}) fp32 {row['k1_ms_float32']:.3f} ms, bf16 "
            f"{row['k1_ms_bfloat16']:.3f} (lstm_cluster.cu "
            f"{row['k1_cluster_ms_float32']:.3f}, lstm_wave.cu "
            f"{row['k1_wave_ms_float32']:.3f}; bound "
            f"{bound(row['k1_bound_terms_float32'])[0]:.3f}, plain "
            f"{row['k1_plain_ms']:.1f}, cuDNN fwd TF32 off "
            f"{row['library_fwd_ms']:.3f}, on "
            f"{row['library_fwd_ms_tf32']:.3f}); K2 (route "
            f"{row['k2_route_float32']}/{row['k2_route_bfloat16']}; plans "
            f"{row['k2_plan']}, {row['k2_wave_plan']} rows) "
            + (("device ms in turns lstm_bwd_cluster.cu/lstm_bwd_wave.cu/"
                "lstm_bwd_wave.cu/lstm_bwd_cluster.cu fp32 " + "/".join(
                    f"{v:.3f}" for v in (
                        row["k2_cluster_turns_float32"][0],
                        *row["k2_wave_turns_float32"],
                        row["k2_cluster_turns_float32"][1])) + " ms, bf16 "
                + "/".join(f"{v:.3f}" for v in (
                    row["k2_cluster_turns_bfloat16"][0],
                    *row["k2_wave_turns_bfloat16"],
                    row["k2_cluster_turns_bfloat16"][1])))
               if k2_turns else
               f"fp32 {row['k2_ms_float32']:.3f} ms, bf16 "
               f"{row['k2_ms_bfloat16']:.3f}") + " (bound "
            f"{bound(row['k2_bound_terms_float32'])[0]:.3f} "
            f"{bound(row['k2_bound_terms_float32'])[1]}, plain "
            f"{row['k2_plain_ms']:.1f}); whole LSTM backward "
            f"{row['port_bwd_ms']:.3f} ms (forward {row['port_fwd_ms']:.3f}),"
            f" cuDNN backward TF32 off {row['library_bwd_ms']:.3f}, on "
            f"{row['library_bwd_ms_tf32']:.3f}")
    return rows


# the training shapes where lstm_bwd_wave.cu is held to beat
# lstm_bwd_cluster.cu (phase 9): FN-SSL's narrow band (298, 4096, 256) and
# full band (256, 4768, 128, both directions)
K2_TARGETS = ("train_narrowband", "train_fullband")


def check_k2_target(rows):
    """Fails unless bwd_route gives each of K2_TARGETS to lstm_bwd_wave.cu
    in float32, and lstm_bwd_wave.cu measured faster than
    lstm_bwd_cluster.cu wherever the rule gives it a target (phase 9's
    device times)."""
    for name in K2_TARGETS:
        row = next(r for r in rows if r["shape"] == name)
        for dtype in ("float32", "bfloat16"):
            route = row[f"k2_route_{dtype}"]
            if (dtype == "float32" and route != "wave") or (
                    route == "wave" and not row[f"k2_wave_ms_{dtype}"]
                    < row[f"k2_cluster_ms_{dtype}"]):
                raise AssertionError(
                    f"K2 at {name} {dtype}: route {route}, "
                    f"lstm_bwd_wave.cu {row[f'k2_wave_ms_{dtype}']} ms "
                    f"against lstm_bwd_cluster.cu "
                    f"{row[f'k2_cluster_ms_{dtype}']}")


def phase_bwd_plans(device, shapes=TRAIN_SHAPES):
    """Every plan of lstm_bwd_cluster.cu that fits at the training shapes,
    fp32 and bf16."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    rows = []
    for name, t, b, h, _, ndir in shapes:
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            args = bwd_inputs((ndir,), t, b, h, tdt, device, 8)
            if ndir == 1:
                args = tuple(a[0] for a in args)
            default = L.bwd_cluster_plan(h, tdt.itemsize)
            bt = L.BWD_TILE
            plans = [(n, bt, ks, upt) for n in L.CLUSTER_SIZES
                     for ks in (h // 16, h // 8) for upt in L.BWD_UPTS
                     if L.bwd_cluster_fits(h, tdt.itemsize, n, bt, ks, upt)]
            for plan in plans:
                fn = L.lstm_bwd_bidir if ndir == 2 else L.lstm_bwd
                ms = cuda_ms(lambda: fn(*args, route="cluster", plan=plan),
                             3)
                rows.append({"shape": name, "dtype": dtype,
                             **dict(zip(("N", "Bt", "KS", "UPT"), plan)),
                             "ms": ms, "default": plan == default})
                log(f"  {name:16s} {dtype:8s} N={plan[0]} Bt={plan[1]:2d} "
                    f"KS={plan[2]:2d} UPT={plan[3]}: {ms:.3f} ms"
                    + (" (default)" if plan == default else ""))
            del args
    return rows


# phase 9's sweep of lstm_bwd_wave.cu against lstm_bwd_cluster.cu, which
# sets bwd_route's thresholds: B (a direction) x H x directions x dtype at T
# BWD_SWEEP_T, and phase 5's SWEEP_EXTRA points
BWD_SWEEP_B, BWD_SWEEP_H, BWD_SWEEP_T = (1024, 2048, 4096, 4768), (128, 256), \
    298


def phase_bwd_sweep(device):
    """lstm_bwd_wave.cu (bwd_wave_plan's plan) against lstm_bwd_cluster.cu
    (bwd_cluster_plan's) over the sweep and SWEEP_EXTRA, CUDA events, one
    launch of ndir directions; each point's route by bwd_route beside the
    faster kernel. Fails where the rule sends a shape to lstm_bwd_wave.cu
    that measured slower there. Returns the rows and the thresholds the
    points give (`sweep_thresholds`)."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    rows, against = [], []

    def point(dtype, t, b, h, ndir):
        tdt = getattr(torch, dtype)
        args = bwd_inputs((ndir,), t, b, h, tdt, device, 12)
        fn = L.lstm_bwd_bidir if ndir == 2 else L.lstm_bwd
        if ndir == 1:
            args = tuple(a[0] for a in args)
        ms = {r: cuda_ms(lambda: fn(*args, route=r), 3)
              for r in ("cluster", "wave")}
        del args
        route = L.bwd_route(t, b, h, ndir, tdt.itemsize)
        row = {"dtype": dtype, "T": t, "B": b, "H": h, "ndir": ndir,
               "route": route, "cluster_ms": ms["cluster"],
               "wave_ms": ms["wave"],
               "wave_plan": L.bwd_wave_plan(h, tdt.itemsize, b, ndir),
               "bound_ms": ndir * bound(bwd_bound_terms(
                   t, b, h, tdt.itemsize))[0]}
        rows.append(row)
        if route == "wave" and not ms["wave"] < ms["cluster"]:
            against.append(row)
        return row

    def line(pts):
        return " ".join(f"{r['B']}:{r['cluster_ms']:.3f}/{r['wave_ms']:.3f}"
                        f"{'*' if r['route'] == 'wave' else ''}" for r in pts)

    t = BWD_SWEEP_T
    for dtype in ("float32", "bfloat16"):
        for h in BWD_SWEEP_H:
            for ndir in (1, 2):
                pts = [point(dtype, t, b, h, ndir) for b in BWD_SWEEP_B]
                log(f"  {dtype:8s} H={h} ndir={ndir} T={t} B: cluster/wave "
                    "ms (* routed to lstm_bwd_wave.cu) " + line(pts))
        for te, b, h, ndir in SWEEP_EXTRA:
            log(f"  {dtype:8s} H={h} ndir={ndir} T={te} B: cluster/wave ms "
                + line([point(dtype, te, b, h, ndir)]))
    measured = sweep_thresholds(rows)
    thresholds = {f"H={h} itemsize={i}": n
                  for (h, i), n in L.BWD_WAVE_MIN_ROWS.items()}
    log(f"  {len(rows)} points; bwd_route's thresholds (rows = B x ndir) "
        f"{thresholds}; the sweep's (at least {1 - WAVE_MARGIN:.0%} faster "
        f"from these rows up) {measured}")
    if against:
        raise AssertionError(f"bwd_route sends to lstm_bwd_wave.cu shapes "
                             f"where it measured slower: {against}")
    return rows, measured


# FN-SSL at FNSSLConfig(hidden_size=512), every other width published:
# narrow-band LSTMs of H 512 (K1 on lstm_wide.cu, K2 on lstm_bwd_wide.cu) and
# full-band BiLSTMs of H 256 (T 256). (name, T, B, H, I, ndir) of one train
# step's recurrences at nb 16 (I: the input width the cuDNN yardstick and
# the whole LSTM backward are timed with), and K1's small-B check case
WIDE_HIDDEN, WIDE_NB, WIDE_STEPS = 512, 16, 3
WIDE_TRAIN_SHAPES = [
    ("wide_fullband", 256, WIDE_NB * 298, WIDE_HIDDEN // 2, WIDE_HIDDEN, 2),
    ("wide_narrowband", 298, WIDE_NB * 256, WIDE_HIDDEN, WIDE_HIDDEN, 1)]
WIDE_TIMED_SHAPES = WIDE_TRAIN_SHAPES + [("v2_case", *V2_CASE, 512, 1)]
# the parity step: nb 1 x 2 s (124 frames), so that the CPU's step stays
# near 11 s (25 s at 4.79 s on 8 cores)
WIDE_PARITY_NB, WIDE_PARITY_T_S = 1, 2.0
# K2 above H = 256 on the card: every width the rule gives lstm_bwd_wide.cu
# that FN-SSL does not (two columns a lane from 544), at phase 6's edge cases
# and one row past the largest tile; every plan at T 7, B 77
WIDE_EDGE_H = (288, 384, 512, 768, 1024)
WIDE_PLAN_H = (288, 512, 544, 1024)


def frames(t_s):
    """Frames of the FN-SSL front-end for t_s seconds of audio (hop 256,
    the STFT's last two frames dropped): 298 at 4.79 s, 124 at 2 s."""
    return int(t_s * FS) // 256 - 1


def bwd_wide_cases():
    """(name, T, B, H, route, plan) at which phase 6 holds lstm_bwd_wide.cu
    beyond the rule's calls at the wide training shapes: WIDE_EDGE_H at B
    1/11/13/17 and one row past the largest tile, T 1/2/7, through the
    rule; an LSTM of H 48, padded to 64 (lstm_bwd_cluster.cu)."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    cases = []
    for h in WIDE_EDGE_H:
        past = max(L.bwd_wide_tile(p) for p in L.bwd_wide_plans(h)) + 1
        cases += [("wide edge", t, b, h, None, None)
                  for b in EDGE_B + (past,) for t in BWD_EDGE_T]
    cases += [("padded H 48", t, 13, 48, None, None) for t in BWD_EDGE_T]
    return cases


def refusals(device):
    """Above H = 1024 and d_state 64 the card raises, through every entry
    point, and launches nothing: K1 and K2 at H 1056, K3 and K4 at n 72."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L
    from fnssl_tpu_torch.kernels import ssm_cuda as S

    counts = launch_counters()
    before = [c.value for c in counts]
    fwd = lstm_inputs(3, 4, 1056, torch.float32, device, 1, ndir=2)
    bwd = bwd_inputs((2,), 3, 4, 1056, torch.float32, device, 1)
    x = ssm_inputs(2, 3, 32, torch.float32, device, 1, n=72)
    args = [x[k] for k in SSM_ARGS]
    calls = [("lstm_fwd_bidir H 1056", L.lstm_fwd_bidir, fwd, "up to 1024"),
             ("lstm_fwd H 1056", L.lstm_fwd, [a[0] for a in fwd],
              "up to 1024"),
             ("lstm_bwd_bidir H 1056", L.lstm_bwd_bidir, bwd, "up to 1024"),
             ("lstm_bwd H 1056", L.lstm_bwd, [a[0] for a in bwd],
              "up to 1024"),
             ("selective_scan_fwd n 72", S.selective_scan_fwd, args,
              "d_state=72"),
             ("selective_scan_bwd n 72", S.selective_scan_bwd,
              args + [x["dy"], x["dh_last"]], "d_state=72")]
    for what, fn, a, msg in calls:
        try:
            fn(*a)
        except ValueError as e:
            if msg not in str(e):
                raise AssertionError(f"{what}: raised {e!r}") from e
        else:
            raise AssertionError(f"{what} ran; the card must refuse it")
    if [c.value for c in counts] != before:
        raise AssertionError("a refused call launched a kernel")
    log(f"  refused, nothing launched: {', '.join(c[0] for c in calls)}")
    return [c[0] for c in calls]


def library_times(i, h, bidir, x, gy, iters):
    """nn.LSTM (cuDNN; the yardstick, never called by the port) at input
    x and output gradient gy: its forward alone under no_grad and its
    backward (forward+backward less forward), CUDA events, in fp32 with
    TF32 off ("library_fwd_ms", "library_bwd_ms") and on ("_tf32"), and
    with bf16 weights and inputs ("_bf16")."""
    out = {}
    ref = torch.nn.LSTM(i, h, batch_first=True,
                        bidirectional=bidir).to(x.device)
    for tf32 in LIBRARY_TF32:
        with library_flags(tf32):
            with torch.no_grad():
                out[library_key("library_fwd_ms", tf32)] = cuda_ms(
                    lambda: ref(x), iters)
            fwd_grad = cuda_ms(lambda: ref(x), iters)
            both = cuda_ms(lambda: torch.autograd.backward(ref(x)[0], gy),
                           iters)
        out[library_key("library_bwd_ms", tf32)] = both - fwd_grad
    ref, xb, gb = ref.bfloat16(), x.bfloat16(), gy.bfloat16()
    ref.flatten_parameters()      # else cuDNN compacts the weights each call
    with torch.no_grad():
        out["library_fwd_ms_bf16"] = cuda_ms(lambda: ref(xb), iters)
    fwd_grad = cuda_ms(lambda: ref(xb), iters)
    both = cuda_ms(lambda: torch.autograd.backward(ref(xb)[0], gb), iters)
    out["library_bwd_ms_bf16"] = both - fwd_grad
    return out


def phase_wide_times(device, shapes=WIDE_TIMED_SHAPES):
    """K1 and K2 at `shapes` (FN-SSL's recurrences at hidden_size 512 and
    K1's small-B check case above H = 256), each on the kernel its rule
    gives it, fp32 and bf16: the card's time of a launch from a trace
    (device_ms), the bound and K2's share of it (bound / time), the plain
    version (fp32), cuDNN's forward and backward (`library_times`: fp32
    with TF32 off and on, bf16; cuDNN's bf16 LSTM multiplies in bf16 on
    the tensor cores, not the float32 products the port computes), and
    the port's whole LSTM backward. Above H = 256, K2's plan (rows a
    thread of lstm_bwd_wide.cu)."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L
    from fnssl_tpu_torch.models.lstm import lstm

    rows = []
    for name, t, b, h, i, ndir in shapes:
        bidir = ndir == 2
        row = {"shape": name, "T": t, "B": b, "H": h, "I": i, "ndir": ndir}
        if h > L.CLUSTER_MAX_HIDDEN:
            row["k2_plan"] = L.bwd_wide_plan(h, b, ndir)
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            row[f"k1_route_{dtype}"] = L.fwd_route(t, b, h, ndir,
                                                   tdt.itemsize)
            row[f"k2_route_{dtype}"] = L.bwd_route(t, b, h, ndir,
                                                   tdt.itemsize)
            args = lstm_inputs(t, b, h, tdt, device, 7, ndir=ndir)
            k1, k1_plain = ((L.lstm_fwd_bidir, L.lstm_fwd_bidir_plain)
                            if bidir else (L.lstm_fwd, L.lstm_fwd_plain))
            if not bidir:
                args = tuple(a[0] for a in args)
            row[f"k1_ms_{dtype}"] = device_ms(lambda: k1(*args), 3)
            row[f"k1_bound_terms_{dtype}"] = {
                k: ndir * v for k, v in bound_terms(t, b, h,
                                                    tdt.itemsize).items()}
            if dtype == "float32":
                row["k1_plain_ms"] = cuda_ms(lambda: k1_plain(*args), 1)
            args = bwd_inputs((ndir,), t, b, h, tdt, device, 8)
            k2, k2_plain = ((L.lstm_bwd_bidir, L.lstm_bwd_bidir_plain)
                            if bidir else (L.lstm_bwd, L.lstm_bwd_plain))
            if not bidir:
                args = tuple(a[0] for a in args)
            row[f"k2_ms_{dtype}"] = device_ms(lambda: k2(*args), 3)
            row[f"k2_bound_terms_{dtype}"] = {
                k: ndir * v for k, v in bwd_bound_terms(t, b, h,
                                                        tdt.itemsize).items()}
            row[f"k2_bound_share_{dtype}"] = (
                bound(row[f"k2_bound_terms_{dtype}"])[0]
                / row[f"k2_ms_{dtype}"])
            if dtype == "float32":
                row["k2_plain_ms"] = cuda_ms(lambda: k2_plain(*args), 1)
            del args
        params, x, gy = lstm_grad_case(t, b, h, i, ndir, device, 9)
        out, _ = lstm(params, x, None, bidir)
        row["port_bwd_ms"] = cuda_ms(lambda: torch.autograd.backward(
            [out], [gy], retain_graph=True), 3)
        del out, params
        row.update(library_times(i, h, bidir, x, gy, 3))
        del x, gy
        torch.cuda.empty_cache()
        for k in ("k1", "k2"):
            row[f"{k}_bound_ms"], row[f"{k}_bound_by"] = bound(
                row[f"{k}_bound_terms_float32"])
        rows.append(row)
        log(f"  {name:16s} T={t} B={b} H={h} ndir={ndir}: K1 "
            f"({row['k1_route_float32']}) fp32 {row['k1_ms_float32']:.3f} ms,"
            f" bf16 {row['k1_ms_bfloat16']:.3f} (bound "
            f"{row['k1_bound_ms']:.3f} {row['k1_bound_by']}, plain "
            f"{row['k1_plain_ms']:.1f}, cuDNN fwd TF32 off "
            f"{row['library_fwd_ms']:.3f}, on {row['library_fwd_ms_tf32']:.3f}"
            f", bf16 {row['library_fwd_ms_bf16']:.3f})"
            f"; K2 ({row['k2_route_float32']}/{row['k2_route_bfloat16']}"
            + (f", R {row['k2_plan']}" if "k2_plan" in row else "")
            + f") fp32 {row['k2_ms_float32']:.3f} ms "
            f"({row['k2_bound_share_float32']:.0%} of the bound), bf16 "
            f"{row['k2_ms_bfloat16']:.3f} "
            f"({row['k2_bound_share_bfloat16']:.0%}) (bound "
            f"{row['k2_bound_ms']:.3f} "
            f"{row['k2_bound_by']}, plain {row['k2_plain_ms']:.1f}, cuDNN bwd "
            f"TF32 off {row['library_bwd_ms']:.3f}, on "
            f"{row['library_bwd_ms_tf32']:.3f}, bf16 "
            f"{row['library_bwd_ms_bf16']:.3f}); whole LSTM backward "
            f"{row['port_bwd_ms']:.3f}")
    return rows


def phase_wide_train(seed, device):
    """FN-SSL at FNSSLConfig(hidden_size=512): one fp32 train step (nb
    WIDE_PARITY_NB x WIDE_PARITY_T_S s, dropout off) on the card against
    the CPU at phase 7's tolerances, its launches as the rules split them;
    then the cell nb WIDE_NB x 4.79 s, fp32 then bf16, 1 warm +
    WIDE_STEPS timed steps each (ms mean and p90, peak memory, exact
    launches: 3 K1 on lstm_wide.cu and 3 on lstm_wave.cu, 3 K2 on
    lstm_bwd_wide.cu and 3 on lstm_bwd_wave.cu a step), and one traced
    step of each (K1's and K2's device ms, busy time, idle share)."""
    setup = functools.partial(train_setup, seed, nb=WIDE_PARITY_NB,
                              hidden=WIDE_HIDDEN, t_s=WIDE_PARITY_T_S)
    report = {"parity": phase_train_parity(
        seed, device, setup, want=step_launches(
            WIDE_PARITY_NB, hidden=WIDE_HIDDEN,
            nt=frames(WIDE_PARITY_T_S)))}
    total = list(report["parity"]["launches"])
    counts = launch_counters()
    for c in counts:
        c.reset()
    for precision in ("fp32", "bf16"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, step, batch = train_setup(seed, device, WIDE_NB, precision,
                                         WIDE_HIDDEN)
        gen = torch.Generator(device=device).manual_seed(seed)
        state, ms, losses = timed_steps(state, step, batch, gen, WIDE_STEPS)
        if not np.isfinite(losses).all():
            raise AssertionError(f"hidden {WIDE_HIDDEN} {precision}: losses "
                                 f"{losses}")
        row = {"ms_mean": float(ms.mean()),
               "ms_p90": float(np.percentile(ms, 90)), "ms": ms.tolist(),
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "losses": losses}
        log(f"  hidden {WIDE_HIDDEN} nb={WIDE_NB} x {TRAIN_T_S} s "
            f"{precision}: step ms mean {row['ms_mean']:.2f} p90 "
            f"{row['ms_p90']:.2f} over {WIDE_STEPS} steps; peak "
            f"{row['peak_bytes'] / 2**30:.2f} GiB; losses "
            + ", ".join(f"{v:.6f}" for v in losses))
        launched = [c.value for c in counts]
        prof = profile_step(lambda: step(state, batch, gen),
                            ("lstm_bwd_wide_kernel",))
        if not prof["busy_ms"]:
            raise AssertionError("the profiler saw no kernel on the card")
        row["profile"] = prof
        row["k1_device_ms"] = prof["groups_ms"]["K1"]
        row["k2_device_ms"] = prof["groups_ms"]["K2"]
        row["k2_wide_device_ms"] = prof["ms_of"]["lstm_bwd_wide_kernel"]
        if not row["k2_wide_device_ms"] > 0:
            raise AssertionError(f"hidden {WIDE_HIDDEN} {precision}: the "
                                 "traced step holds no lstm_bwd_wide_kernel")
        log(f"  traced {precision} step: wall {prof['wall_ms']:.2f} ms, busy "
            f"{prof['busy_ms']:.2f} ms, idle share {prof['idle_share']:.2%}; "
            f"K1 {row['k1_device_ms']:.2f} ms, K2 {row['k2_device_ms']:.2f} "
            f"(lstm_bwd_wide.cu {row['k2_wide_device_ms']:.2f}); "
            "busy by group " + ", ".join(
                f"{g} {v:.2f}" for g, v in prof["groups_ms"].items()))
        per = step_launches(WIDE_NB, 4 if precision == "fp32" else 2,
                            WIDE_HIDDEN)
        want = [(1 + WIDE_STEPS) * n for n in per]
        if launched != want:
            raise AssertionError(f"hidden {WIDE_HIDDEN} {precision} training "
                                 f"launched {COUNTED} {launched}, expected "
                                 f"{want}")
        row["launches_per_step"] = dict(zip(COUNTED, per))
        report[precision] = row
        # the timed steps and the traced one
        total = [a + (2 + WIDE_STEPS) * n for a, n in zip(total, per)]
        for c in counts:
            c.reset()
        del state, step, batch
    torch.cuda.empty_cache()
    log(f"  launches a step {COUNTED}: fp32 "
        f"{list(report['fp32']['launches_per_step'].values())}, bf16 "
        f"{list(report['bf16']['launches_per_step'].values())}")
    return report, dict(zip(COUNTED, total))


def cli(argv):
    """The port's CLI main(argv) in this process; echoes its output and
    returns (its last line as JSON, all of its output, seconds)."""
    from fnssl_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        if not line.startswith("generated "):
            log(f"    {line}")
    return json.loads(out.strip().splitlines()[-1]), out, seconds


def counted_cli(argv, want, what):
    """cli(argv) with every launch counter set to 0 just before it and read
    just after; fails unless the counts are `want` (in COUNTED's order)."""
    counts = launch_counters()
    for c in counts:
        c.reset()
    result, out, seconds = cli(argv)
    launched = [c.value for c in counts]
    if launched != want:
        raise AssertionError(f"{what} launched {COUNTED} {launched}, "
                             f"expected {want}")
    log(f"  {what}: launches {COUNTED} {launched}, {seconds:.2f} s")
    return result, out, launched, seconds


def loader_stages(data_dir, bz, device, compact_dir):
    """Seconds of each host stage of one train batch, run serially on the
    dataset fit reads: the items as fit's loader fetches them (scene reads
    and Segmenting), the same items read without Segmenting, collate, and
    the pinned copy to the card; and, for comparison, a batch's worth of
    compact npz items (which hold the segmented labels)."""
    from fnssl_tpu_torch.data import (FixTrajectoryDataset, Segmenting,
                                      collate_segmented, prefetch_to_device)

    def fetched(ds):
        t0 = time.perf_counter()
        items = [ds[i] for i in range(bz)]
        return items, time.perf_counter() - t0

    t = {}
    _, t["read"] = fetched(FixTrajectoryDataset(
        str(data_dir), return_acoustic_scene=True))
    items, t["fetch"] = fetched(FixTrajectoryDataset(
        str(data_dir), transforms=[Segmenting()]))
    t["segment"] = t["fetch"] - t["read"]
    t0 = time.perf_counter()
    batch = collate_segmented(items)
    t["collate"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    list(prefetch_to_device([batch], device=device))
    torch.cuda.synchronize()
    t["copy"] = time.perf_counter() - t0
    compact = FixTrajectoryDataset(str(compact_dir))
    t0 = time.perf_counter()
    for i in range(len(compact)):
        compact[i]
    t["compact_read"] = (time.perf_counter() - t0) / len(compact) * bz
    return t


def epoch_stats(log_dir):
    """Per epoch, from the fit's metrics.jsonl: train seconds, steps, the
    seconds the loop waited on the loader and, of those, the wait for the
    first batch; and the steady state after the first batch: ms a step
    and the share of that time the loop waited on the loader."""
    stats = {}
    for line in open(Path(log_dir) / "metrics.jsonl"):
        rec = json.loads(line)
        if rec["tag"] in ("train/epoch_s", "train/steps",
                          "train/loader_wait_s", "train/first_batch_wait_s"):
            stats.setdefault(rec["step"], {})[rec["tag"][6:]] = rec["value"]
    for st in stats.values():
        after = st["epoch_s"] - st["first_batch_wait_s"]
        st["ms_per_step"] = st["epoch_s"] / st["steps"] * 1e3
        st["steady_ms_per_step"] = after / st["steps"] * 1e3
        st["steady_loader_wait_share"] = (
            st["loader_wait_s"] - st["first_batch_wait_s"]) / after
    return [stats[e] for e in sorted(stats)]


def ipd_recurrences(rows, nt=280, online=True, nf=256):
    """(T, B, H, ndir, n) of one IPDnet forward (IPDnetConfig(),
    VariableIPDnetConfig(): 2 blocks) on `rows` utterances (nb, or nb x
    mic pairs for the variable model) of nt frames: a full-band BiLSTM (T
    nf, B rows nt, H 64) and a narrow-band LSTM (T nt, B rows nf; H 128
    online, H 64 both directions offline) a block."""
    narrow = (nt, rows * nf, 128, 1, 2) if online else \
        (nt, rows * nf, 64, 2, 2)
    return [(nf, rows * nt, 64, 2, 2), narrow]


def ipd_step_launches(rows, online=True, itemsize=4):
    """Launches (COUNTED's order) of one IPDnet train step on `rows`
    utterances of 4.5 s: K1 of its forward and a K2 launch for each of
    its recurrences, each on the kernel the rule gives it."""
    recs = ipd_recurrences(rows, online=online)
    out = k1_split(recs, itemsize)
    for t_steps, batch, hidden, ndir, n in recs:
        name, _ = k2_route(t_steps, batch, hidden, ndir, itemsize)
        out[COUNTED.index(name)] += n
    return out


def path_launches(train, train_steps, evals, eval_batches, extra=None):
    """Launches in COUNTED's order of `train_steps` train steps of `train`
    launches each (a step's launches, COUNTED's order), `eval_batches`
    eval forwards of `evals` each, and `extra` more (both lists too)."""
    extra = extra or [0] * len(COUNTED)
    return [train_steps * a + eval_batches * b + c
            for a, b, c in zip(train, evals, extra)]


def fnssl_path_launches(train_steps, eval_batches, nb_train=FIT_BZ,
                        nb_eval=FIT_DEV):
    """Launches in COUNTED's order of `train_steps` FN-SSL train steps of
    nb_train scenes and `eval_batches` eval forwards of nb_eval (phase
    10's corpus: 4.79 s scenes, FIT_DEV dev scenes in one batch)."""
    step, fwd = step_launches(nb_train), fnssl_k1(nb_eval)
    return [train_steps * a + eval_batches * b for a, b in zip(step, fwd)]


def fit_and_test(model, data, log_dir, epochs, train_size, bz, seed,
                 want_fit, want_test):
    """`cli fit` (the first `train_size` scenes of data/train, data/dev)
    then `cli test` of `model`, with exact launch counts (`want_fit`,
    `want_test`); checks finite losses, the checkpoint files, the test loss
    against the fit's final valid loss (1e-6) and finite ACC/MAE. Returns
    its report and the launches of both."""
    common = ["--model", model, "--bz", str(bz), "--seed", str(seed),
              "--log-dir", str(log_dir)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fit, _, launched, fit_s = counted_cli(
        ["fit", *common, "--train-dir", str(data / "train"), "--valid-dir",
         str(data / "dev"), "--epochs", str(epochs), "--train-size",
         str(train_size)], want_fit,
        f"fit {model} ({epochs} epochs of {train_size} scenes)")
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(fit["final_train"])
            and np.isfinite(fit["final_valid"])):
        raise AssertionError(f"fit {model}: losses {fit}")
    for f in [f"ckpt/epoch_{e}.tar" for e in range(epochs)] + [
            "ckpt/index.json", "best_model.tar", "config.json"]:
        if not (log_dir / f).exists():
            raise AssertionError(f"fit {model}: no {f}")
    test, _, tested, _ = counted_cli(
        ["test", *common, "--data-dir", str(data / "dev")], want_test,
        f"test {model}")
    if not abs(test["loss"] - fit["final_valid"]) <= 1e-6:
        raise AssertionError(f"test {model}: loss {test['loss']} vs the "
                             f"fit's final valid {fit['final_valid']}")
    if not all(np.isfinite(test[k]) for k in ("ACC", "MAE")):
        raise AssertionError(f"test {model}: metrics {test}")
    return ({"fit": fit, "fit_s": fit_s, "test": test, "peak_bytes": peak,
             "epochs": epoch_stats(log_dir)},
            [a + b for a, b in zip(launched, tested)])


def test_best(model, bz, log_dir, data_dir, want):
    """`cli test --best`: it must restore the epoch of the least valid
    loss in ckpt/index.json and give that loss. Returns its result and
    launches."""
    best, out, tested, _ = counted_cli(
        ["test", "--model", model, "--bz", str(bz), "--log-dir",
         str(log_dir), "--data-dir", str(data_dir), "--best"], want,
        f"test --best {model}")
    index = json.loads((log_dir / "ckpt/index.json").read_text())
    best_epoch = min(sorted(index, key=int), key=lambda e: index[e])
    if f"resumed from epoch {best_epoch}" not in out or not abs(
            best["loss"] - index[best_epoch]) <= 1e-6:
        raise AssertionError(f"test --best {model}: {best}, index {index}")
    return best, tested


def serve_after_fit(model, log_dir, audio):
    """`cli serve --model model` from the fit's best_model.tar, one TCP
    connection of `audio`: lines, eof and the model's CHUNK_LAUNCHES a
    chunk step. Returns the lines and the launches."""
    from fnssl_tpu_torch.cli.main import build_parser, build_server
    from fnssl_tpu_torch.runtime.server import stream_client

    args = build_parser().parse_args(
        ["serve", "--model", model, "--port", "0", "--log-dir",
         str(log_dir)])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        server, _ = build_server(args)
    if "no checkpoint" in buf.getvalue():
        raise AssertionError(f"serve {model} did not find the fit's "
                             "best_model.tar")
    server.start()
    counts = launch_counters()
    try:
        for c in counts:
            c.reset()
        msgs = stream_client("127.0.0.1", server.port, audio, block=1600)
        served = [c.value for c in counts]
    finally:
        server.shutdown()
    n_out = len(msgs) - 1
    if not (n_out > 0 and msgs[-1] == {"eof": True, "outputs": n_out}
            and served == [n * n_out for n in CHUNK_LAUNCHES[model]]):
        raise AssertionError(f"serve {model} after fit: {n_out} lines, eof "
                             f"{msgs[-1]}, launches {served}")
    log(f"  serve {model} from the fit's best_model.tar: {n_out} lines and "
        f"eof; launches {COUNTED} {served}")
    return n_out, served


def phase_fit(seed, device, card, step_ms, work):
    """The user's training loop through the CLI, in-process on the card at
    full width: simulate, fit, test (latest and best) and serve fnssl from
    the fit's best_model.tar; fit and test fnssl_doa. The corpus and the
    runs stay under `work` (work/data, work/runs) for phases 26 and 28."""
    from fnssl_tpu_torch.sim import native

    valid_batches = -(-FIT_DEV // FIT_BZ)
    want = fnssl_path_launches
    # the numpy ISM takes ~20x longer: fail before simulating with it
    if not native.native_available():
        raise AssertionError(f"the native ISM did not build: "
                             f"{native.build_error('ism')}")
    report = {"card": card}
    data, runs = work / "data", work / "runs"
    sims = []
    for sub, num, seed_, extra in (("train", FIT_TRAIN, 1, []),
                                   ("dev", FIT_DEV, 77, ["--compact"])):
        sim, _, seconds = cli(["simulate", "--out", str(data / sub),
                               "--num", str(num), "--T", str(TRAIN_T_S),
                               "--seed", str(seed_), *extra])
        sims.append(sim)
        if sim["ism_engine"] != "native C++/OpenMP":
            raise AssertionError(f"simulate {sub} ran the "
                                 f"{sim['ism_engine']} ISM")
        log(f"  simulate {sub}: {num} scenes of {TRAIN_T_S} s in "
            f"{sim['seconds']:.2f} s, {sim['seconds'] / num:.3f} s a "
            f"scene, ISM engine {sim['ism_engine']} ({sim['threads']} "
            f"threads); {card}")
    report["simulate"] = sims
    launches = {}
    fnssl, launches["fnssl"] = fit_and_test(
        "fnssl", data, runs / "fnssl", FIT_EPOCHS, FIT_TRAIN, FIT_BZ,
        seed, want(FIT_EPOCHS * (FIT_TRAIN // FIT_BZ),
                   FIT_EPOCHS * valid_batches), want(0, valid_batches))
    fnssl["test_best"], tested = test_best(
        "fnssl", FIT_BZ, runs / "fnssl", data / "dev",
        want(0, valid_batches))
    launches["fnssl"] = [a + b for a, b in zip(launches["fnssl"], tested)]
    fnssl["serve_lines"], launches["serve_after_fit"] = serve_after_fit(
        "fnssl", runs / "fnssl", make_audio(seed + 200, 4))
    report["fnssl"] = fnssl
    report["fnssl_doa"], launches["fnssl_doa"] = fit_and_test(
        "fnssl_doa", data, runs / "doa", 1, FIT_DOA_TRAIN, FIT_BZ, seed,
        want(FIT_DOA_TRAIN // FIT_BZ, valid_batches),
        want(0, valid_batches))
    report["loader_stages_s"] = loader_stages(data / "train", FIT_BZ,
                                              device, data / "dev")

    warm = fnssl["epochs"][-1]
    ms = warm["steady_ms_per_step"]
    report.update({
        "fit_ms_per_step": warm["ms_per_step"], "steady_ms_per_step": ms,
        "synthetic_step_ms": step_ms, "overhead_ms": ms - step_ms,
        "overhead_share": (ms - step_ms) / step_ms,
        "first_batch_wait_s": warm["first_batch_wait_s"],
        "loader_wait_share": warm["steady_loader_wait_share"],
        "launches": launches})
    total = [sum(v[i] for v in launches.values())
             for i in range(len(COUNTED))]
    for e, st in enumerate(fnssl["epochs"]):
        log(f"  fnssl epoch {e}: {st['epoch_s']:.3f} s of train steps "
            f"({int(st['steps'])} steps, {st['ms_per_step']:.1f} ms a step)"
            f", of it {st['first_batch_wait_s']:.3f} s waiting for the first"
            f" batch; after it {st['steady_ms_per_step']:.1f} ms a step, "
            f"loader wait {st['loader_wait_s'] - st['first_batch_wait_s']:.3f}"
            f" s ({st['steady_loader_wait_share']:.1%}); {card}")
    log(f"  fit's warm epoch after its first batch: {ms:.2f} ms a train step "
        f"against phase 8's synthetic step {step_ms:.2f} ms: overhead "
        f"{ms - step_ms:+.2f} ms ({report['overhead_share']:+.1%}), loader "
        f"wait {report['loader_wait_share']:.1%}; first batch "
        f"{warm['first_batch_wait_s']:.3f} s; {card}")
    stages = report["loader_stages_s"]
    log("  one train batch's host stages, serial: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()) + f"; {card}")
    log(f"  peak device memory: fit fnssl {fnssl['peak_bytes'] / 2**30:.2f} "
        f"GiB, fit fnssl_doa "
        f"{report['fnssl_doa']['peak_bytes'] / 2**30:.2f} GiB; {card}")
    log(f"  fit path launches {COUNTED} {total}")
    return report, dict(zip(COUNTED, total))


# --------------------------------------------------------------------------
# IPDnet (phases 11-16): IPDnetConfig() (hidden 128, input 4, 2 tracks)
# and VariableIPDnetConfig(), nb scenes of 4.5 s (280 frames, 256 bins, 23
# output frames); the JAX package's cells bench.py:179-214 (fixed array,
# nb 16) and bench.py:217-265 (variable array, nch 4, P = 6 pairs, nb 8)

# the parity steps take nb 1, so that the CPU's steps leave room in the
# script's time limit
IPD_T_S, IPD_NB, IPD_PARITY_NB = 4.5, 16, 1
IPD_VAR_NB, IPD_VAR_NCH = 8, 4
IPD_LR = 5e-4
IPD_LAUNCHES = 4            # K1 a forward, and K2 a train step: 2 blocks
# (name, T, B, H, I, ndir) of one train step: per block a BiLSTM over
# frequency (H 64, B = rows*280) and an LSTM over time (H 128, B =
# rows*256; both directions at H 64 offline); the first block's I
IPD_TRAIN_SHAPES = [
    ("ipdnet_train_fullband", 256, 16 * 280, 64, 4, 2),
    ("ipdnet_train_narrowband", 280, 16 * 256, 128, 132, 1),
    ("ipdnet_offline_narrowband", 280, 16 * 256, 64, 132, 2),
    ("variable_train_fullband", 256, 8 * 6 * 280, 64, 4, 2),
    ("variable_train_narrowband", 280, 8 * 6 * 256, 128, 128, 1)]
# forward only: the serve chunk step, and the offline model's 312-frame
# chunked test at nb 16
IPD_FWD_SHAPES = [
    ("ipdnet_serve_fullband", 256, 12, 64, 4, 2),
    ("ipdnet_serve_narrowband", 12, 256, 128, 132, 1),
    ("offline_chunked_fullband", 256, 16 * 312, 64, 4, 2),
    ("offline_chunked_narrowband", 312, 16 * 256, 64, 132, 2)]
# phase 16: scenes of IPD_T_S s; ipdnet 2 epochs of 4 steps at bz 16 on a
# corpus of 1- and 2-source scenes, ipdnet_offline 1 epoch on it,
# variable_ipdnet 1 epoch of 1 step on a 1-source corpus (its labels are
# not padded to 2 tracks, as in the JAX CLI)
IPD_FIT_TRAIN, IPD_FIT_DEV, IPD_FIT_SINGLE = 64, 8, 16


def phase_ipdnet_kernels(device, worst, worst_bwd, bwd_checks):
    """K1 (both entry points, fp32 and bf16) at every IPDnet shape and K2
    (fp32 and bf16) at the training shapes against their plain versions,
    folded into phases 3's and 6's worst errors. Returns the checks."""
    from fnssl_tpu_torch.kernels import lstm_cuda as L

    seed, checks = 3000, 0
    for name, t, b, h, _, ndir in IPD_TRAIN_SHAPES + IPD_FWD_SHAPES:
        for dtype in ("float32", "bfloat16"):
            seed += 1
            tdt = getattr(torch, dtype)
            errs, kernels = k1_checks(name, t, b, h, dtype, device, seed,
                                      worst)
            checks += 3
            k2 = ""
            if (name, t, b, h, _, ndir) in IPD_TRAIN_SHAPES:
                args = bwd_inputs((ndir,), t, b, h, tdt, device, seed)
                fn, plain = L.lstm_bwd_bidir, L.lstm_bwd_bidir_plain
                if ndir == 1:
                    args = tuple(a[0] for a in args)
                    fn, plain = L.lstm_bwd, L.lstm_bwd_plain
                kernel, counter = k2_route(t, b, h, ndir, tdt.itemsize)
                got = counted(counter, 1, fn, args[0].clone(), *args[1:])
                err = held_bwd(f"{kernel} {name}", got,
                               plain(args[0].clone(), *args[1:]),
                               worst_bwd[kernel], dtype)
                bwd_checks[kernel] += 1
                k2 = f"; K2 {kernel} max|diff| {err:.2e}"
                del args, got
            log(f"  {name:26s} T={t:3d} B={b:5d} H={h:3d} {dtype:8s} K1 "
                f"{'/'.join(kernels)} max|diff| "
                "fwd/rev/bidir ys " + "/".join(f"{e['ys']:.2e}" for e in errs)
                + " hT,cT " + "/".join(f"{max(e['hT'], e['cT']):.2e}"
                                       for e in errs) + k2)
    torch.cuda.empty_cache()
    return checks


def plan_picks(rows, label):
    """Per (shape, dtype): the rule's plan and ms against the fastest plan
    timed; logs them and returns them."""
    picks = []
    for key in dict.fromkeys((r["shape"], r["dtype"]) for r in rows):
        mine = [r for r in rows if (r["shape"], r["dtype"]) == key]
        best = min(mine, key=lambda r: r["ms"])
        rule = next(r for r in mine if r["default"])
        plan = {k: v for k, v in rule.items()
                if k in ("N", "Bt", "KS", "UPT")}
        fastest = {k: v for k, v in best.items()
                   if k in ("N", "Bt", "KS", "UPT")}
        pick = {"shape": key[0], "dtype": key[1], "rule": plan,
                "rule_ms": rule["ms"], "fastest": fastest,
                "fastest_ms": best["ms"],
                "rule_over_fastest": rule["ms"] / best["ms"] - 1.0}
        picks.append(pick)
        log(f"  {label} pick {key[0]:26s} {key[1]:8s} rule {plan} "
            f"{rule['ms']:.4f} ms, fastest {fastest} {best['ms']:.4f} ms "
            f"(rule {pick['rule_over_fastest']:+.1%})")
    return picks


def ipdnet_batch(nb, nch, seed):
    """The JAX package's IPDnet bench batch (bench.py:179-265): nb scenes
    of 4.5 s of noise, 2 tracks at uniform DOAs, unit VAD."""
    rng = np.random.default_rng(seed)
    nsample = int(IPD_T_S * FS)
    nt2 = ((nsample - 512) // 256 + 1) // 12
    return {"mic_sig": rng.standard_normal((nb, nsample, nch)).astype(
                np.float32),
            "doa": rng.uniform(0, np.pi, (nb, nt2, 2, 2)).astype(np.float32),
            "vad": np.ones((nb, nt2, 2), np.float32)}


def variable_mics(nch):
    mic = np.zeros((nch, 3))
    mic[:, 0] = np.linspace(-0.06, 0.06, nch)
    return mic


def ipd_pairs(which, nch):
    """Mic pairs an utterance gives the batch axis: the variable model's
    all pairs of `nch` mics, else one."""
    return nch * (nch - 1) // 2 if which == "variable_ipdnet" else 1


def ipdnet_setup(seed, which, nb, device, precision="fp32", nch=None):
    """(state, step, batch) of an IPDnet task at its published width on
    `device`: weights from `seed`, Adam 5e-4 / gamma 0.975, the bench
    batch on the device; the variable-array task on a linear array of
    `nch` mics (default IPD_VAR_NCH)."""
    from fnssl_tpu_torch.models.ipdnet import IPDnet, VariableIPDnet
    from fnssl_tpu_torch.train import step as S
    from fnssl_tpu_torch.train import tasks as TK

    if which == "variable_ipdnet":
        nch = nch or IPD_VAR_NCH
        task = TK.make_variable_ipdnet_task(
            mic_location=variable_mics(nch), precision=precision,
            device=device)
        cls = VariableIPDnet
    else:
        nch = 2
        make = (TK.make_ipdnet_task if which == "ipdnet"
                else TK.make_ipdnet_offline_task)
        task, cls = make(precision=precision, device=device), IPDnet
    model = cls(task.cfg, device=device,
                generator=torch.Generator().manual_seed(seed))
    tx = S.make_optimizer("adam", IPD_LR, 0.975, 1)
    step = S.make_train_step(task.loss_fn, tx)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in ipdnet_batch(nb, nch, seed).items()}
    return S.init_train_state(model, tx), step, batch


def phase_ipdnet_parity(seed, device):
    """Phase 7's check for each IPDnet task: nb=IPD_PARITY_NB x 4.5 s
    (variable: nch 4, nb 1), dropout off, the card against the CPU."""
    out = {}
    for which, nb in (("ipdnet", IPD_PARITY_NB),
                      ("ipdnet_offline", IPD_PARITY_NB),
                      ("variable_ipdnet", 1)):
        log(f"  {which}, nb={nb}:")
        out[which] = phase_train_parity(
            seed, device, functools.partial(ipdnet_setup, seed, which, nb),
            lr=IPD_LR, want=ipd_step_launches(
                nb * ipd_pairs(which, IPD_VAR_NCH),
                online=which != "ipdnet_offline"),
            gates=("conv.conv1", "conv.conv2"))
    return out


KERNEL_GROUPS = (("K1", ("lstm_cluster", "lstm_wave", "lstm_wide_kernel")),
                 ("K2", ("lstm_bwd_cluster", "lstm_bwd_wave",
                         "lstm_bwd_wide")),
                 ("K3", ("selective_fwd_kernel",)),
                 ("K4", ("selective_bwd_kernel",)),
                 ("conv head", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                                "implicit", "winograd")),
                 ("GEMMs", ("gemm", "gemv", "cutlass", "xmma")),
                 ("copies", ("copy", "cat", "memcpy", "memset")))


def profile_step(step_fn, sums=()):
    """One call of step_fn under torch.profiler: wall ms, the card's busy
    ms (union of kernel intervals), idle share, busy ms by kernel group
    (KERNEL_GROUPS, first match by name, else 'the rest'), the top
    kernels by name and, under "ms_of", the ms of every kernel whose name
    holds each string of `sums`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur = 0.0, None
    for start, end in spans:
        if cur is None or start > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    if cur is not None:
        busy += cur[1] - cur[0]
    busy /= 1e3                                 # the profiler's unit is µs
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["the rest"] = 0.0
    by_name = {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        low = e.name.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in low for k in keys)), "the rest")
        groups[group] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall, "busy_ms": busy, "kernels": len(kernels),
            "idle_share": 1.0 - busy / wall if busy else None,
            "groups_ms": groups,
            "ms_of": {k: sum(ms for n, ms in by_name.items() if k in n)
                      for k in sums},
            "top": [{"kernel": n[:100], "ms": ms} for n, ms in top]}


def timed_steps(state, step, batch, gen, n):
    """1 warm and n timed train steps: (state, ms list, losses)."""
    ms, losses = [], []
    for k in range(1 + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch, gen)
        torch.cuda.synchronize()
        if k:
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return state, np.array(ms), losses


def phase_ipdnet_train(seed, device):
    """The fixed-array cell (nb 16) and the variable-array cell (nch 4, nb
    8) at the published widths, fp32 then the bf16 policy: 1 warm + 5
    timed steps, dropout on; the variable forward; one fp32 step of the
    fixed model under torch.profiler."""
    from fnssl_tpu_torch.train.precision import wrap_apply
    from fnssl_tpu_torch.train.tasks import _apply_module

    rows = {}
    counts = launch_counters()
    for c in counts:
        c.reset()
    want = [0] * len(COUNTED)
    for which, nb in (("ipdnet", IPD_NB), ("variable_ipdnet", IPD_VAR_NB)):
        rows_in = nb * ipd_pairs(which, IPD_VAR_NCH)
        for precision in ("fp32", "bf16"):
            itemsize = 2 if precision == "bf16" else 4
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            state, step, batch = ipdnet_setup(seed, which, nb, device,
                                              precision)
            gen = torch.Generator(device=device).manual_seed(seed)
            state, ms, losses = timed_steps(state, step, batch, gen,
                                            TIMED_STEPS)
            want = path_launches(ipd_step_launches(rows_in,
                                                   itemsize=itemsize),
                                 1 + TIMED_STEPS, [0] * len(COUNTED), 0,
                                 want)
            row = {"ms_mean": float(ms.mean()),
                   "ms_p90": float(np.percentile(ms, 90)),
                   "ms": ms.tolist(),
                   "audio_s_per_s": nb * IPD_T_S / (ms.mean() / 1e3),
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "losses": losses}
            if not np.isfinite(losses).all():
                raise AssertionError(f"{which} {precision}: losses {losses}")
            extra = ""
            if which == "variable_ipdnet":
                # the forward alone on the step's features (bench.py:246-255)
                from fnssl_tpu_torch.train import tasks as TK
                task = TK.make_variable_ipdnet_task(
                    mic_location=variable_mics(IPD_VAR_NCH), device=device)
                feats, _ = task.preprocess(batch["mic_sig"], batch["doa"],
                                           batch["vad"])
                fwd = wrap_apply(_apply_module, precision)
                model = state.module.eval()
                params = dict(model.named_parameters())
                with torch.no_grad():
                    # cuda_ms: 2 warm calls and TIMED_STEPS timed
                    row["fwd_ms"] = cuda_ms(lambda: fwd(
                        params, feats, module=model, npair=6), TIMED_STEPS)
                want = path_launches(
                    [0] * len(COUNTED), 0,
                    k1_split(ipd_recurrences(rows_in), itemsize),
                    2 + TIMED_STEPS, want)
                row["fwd_audio_s_per_s"] = nb * IPD_T_S / (row["fwd_ms"] /
                                                           1e3)
                extra = f"; forward {row['fwd_ms']:.2f} ms"
                del feats, model, params
            rows[f"{which}_{precision}"] = row
            log(f"  {which} nb={nb} {precision}: step ms mean "
                f"{row['ms_mean']:.2f} p90 {row['ms_p90']:.2f} over "
                f"{TIMED_STEPS} steps; {row['audio_s_per_s']:.1f} s of audio "
                f"a second; peak {row['peak_bytes'] / 2**30:.2f} GiB"
                f"{extra}; losses " + ", ".join(f"{v:.6f}" for v in losses))
            del state, step, batch
    launched = [c.value for c in counts]
    if launched != want:
        raise AssertionError(f"IPDnet training launched {COUNTED} "
                             f"{launched} for its steps and the forwards, "
                             f"expected {want} (the rule's kernel at each "
                             "recurrence)")
    log(f"  launches {COUNTED} {launched}: {1 + TIMED_STEPS} steps of each "
        f"cell and precision (each recurrence on the kernel the rule gives "
        f"it) and the timed variable forwards")
    torch.cuda.empty_cache()
    state, step, batch = ipdnet_setup(seed, "ipdnet", IPD_NB, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    state, _ = step(state, batch, gen)
    prof = profile_step(lambda: step(state, batch, gen))
    if not prof["busy_ms"]:
        raise AssertionError("the profiler saw no kernel on the card")
    log(f"  profile of one fp32 ipdnet step: wall {prof['wall_ms']:.2f} ms, "
        f"busy {prof['busy_ms']:.2f} ms, idle share "
        f"{prof['idle_share']:.2%}; busy by group " + ", ".join(
            f"{g} {ms:.2f} ms ({ms / prof['busy_ms']:.1%})"
            for g, ms in prof["groups_ms"].items()))
    for k in prof["top"]:
        log(f"    {k['ms']:9.3f} ms  {k['kernel']}")
    rows["profile_fp32"] = prof
    del state, step, batch
    torch.cuda.empty_cache()
    return rows, dict(zip(COUNTED, launched))


def phase_ipdnet_fit(seed, device, card):
    """The user's IPDnet loop through the CLI on the card: simulate
    (preset ipdnet), fit, test, test --best and serve ipdnet; fit and test
    ipdnet_offline (its test scores the 312-frame chunked inference) and
    variable_ipdnet."""
    from fnssl_tpu_torch.sim import native

    if not native.native_available():
        raise AssertionError(f"the native ISM did not build: "
                             f"{native.build_error('ism')}")
    valid = -(-IPD_FIT_DEV // IPD_NB)
    report = {"card": card}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        data, runs = Path(tmp) / "data", Path(tmp) / "runs"
        sims = []
        for corpus, ns, stage, num, extra in (
                ("mixed", 2, "train", IPD_FIT_TRAIN, []),
                ("mixed", 2, "dev", IPD_FIT_DEV, ["--compact"]),
                ("single", 1, "train", IPD_FIT_SINGLE, []),
                ("single", 1, "dev", IPD_FIT_DEV, ["--compact"])):
            sim, _, _ = cli(["simulate", "--preset", "ipdnet", "--stage",
                             stage, "--out", str(data / corpus / stage),
                             "--num", str(num), "--T", str(IPD_T_S),
                             "--num-source", str(ns), *extra])
            if sim["ism_engine"] != "native C++/OpenMP":
                raise AssertionError(f"simulate ran the {sim['ism_engine']}"
                                     " ISM")
            sims.append(sim)
            log(f"  simulate ipdnet {corpus}/{stage}: {num} scenes of "
                f"{IPD_T_S} s in {sim['seconds']:.2f} s, "
                f"{sim['seconds'] / num:.3f} s a scene; {card}")
        report["simulate"] = sims
        for model, corpus, epochs, train in (
                ("ipdnet", "mixed", 2, IPD_FIT_TRAIN),
                ("ipdnet_offline", "mixed", 1, IPD_FIT_TRAIN),
                ("variable_ipdnet", "single", 1, IPD_FIT_SINGLE)):
            # the simulated array has 2 mics: one pair for the variable
            # model; eval batches of IPD_FIT_DEV scenes
            online = model != "ipdnet_offline"
            step = ipd_step_launches(IPD_NB, online)
            evals = k1_split(ipd_recurrences(IPD_FIT_DEV, online=online))
            # the offline test also runs the chunked inference a batch
            chunked = ([valid * n for n in k1_split(ipd_recurrences(
                IPD_FIT_DEV, online=False))] if model == "ipdnet_offline"
                else None)
            report[model], launches[model] = fit_and_test(
                model, data / corpus, runs / model, epochs, train, IPD_NB,
                seed, path_launches(step, epochs * (train // IPD_NB), evals,
                                    epochs * valid),
                path_launches(step, 0, evals, valid, chunked))
            if model == "ipdnet":
                report[model]["test_best"], tested = test_best(
                    model, IPD_NB, runs / model, data / corpus / "dev",
                    path_launches(step, 0, evals, valid))
                launches[model] = [a + b for a, b in zip(launches[model],
                                                         tested)]
                report[model]["serve_lines"], launches["serve_after_fit"] = \
                    serve_after_fit(model, runs / model,
                                    make_audio(seed + 300, -3))
    for model in ("ipdnet", "ipdnet_offline", "variable_ipdnet"):
        r = report[model]
        for e, st in enumerate(r["epochs"]):
            log(f"  {model} epoch {e}: {st['epoch_s']:.3f} s of train steps "
                f"({int(st['steps'])} steps, {st['ms_per_step']:.1f} ms a "
                f"step), of it {st['first_batch_wait_s']:.3f} s waiting for "
                f"the first batch; after it {st['steady_ms_per_step']:.1f} ms"
                f" a step; {card}")
        log(f"  {model}: fit {r['fit_s']:.2f} s, test loss "
            f"{r['test']['loss']:.6f} = valid {r['fit']['final_valid']:.6f}"
            f", ACC {r['test']['ACC']:.4f} MAE {r['test']['MAE']:.2f}, peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB")
    total = [sum(v[i] for v in launches.values())
             for i in range(len(COUNTED))]
    report["launches"] = launches
    log(f"  IPDnet fit path launches {COUNTED} {total}")
    return report, dict(zip(COUNTED, total))


# IPDnet2 (phases 17-21): SpatialNetConfig() (dim_input 10, dim_output 16,
# 8 layers, hidden 96, 256 bins, d_state 16, d_conv 4) on the 5-mic subset
# of the Westlake array, nb scenes of 4 s (201 frames, 40 labels at 10 Hz);
# the JAX package's cells bench.py:138-176 (train, nb 16, AdamW 5e-4 /
# gamma 0.975, clip 5) and bench.py:460-481 (forward, nb 16, nt 200)
I2_T_S, I2_NB, I2_PARITY_NB, I2_LR, I2_FWD_NT = 4.0, 16, 2, 5e-4, 200
I2_LAUNCHES = 16         # K3 a forward, K4 a train step: 8 layers x 2 blocks
I2_STEP_LAUNCHES = [0, 0, 0, 0, I2_LAUNCHES, I2_LAUNCHES, 0, 0]
# (name, B, L, d) of the scans: a train step at nb 16 (layer 0 at T 201,
# layers 1-7 at 40 after the 5x time mean), the forward cell's layer 0 (T
# 200) and a serve chunk step (5 frames at layer 0, then 1); each path runs
# 2 scans of a layer-0 shape and 14 of the later one
SSM_SHAPES = [("train_layer0", 256, 201, 192), ("train_layers1_7", 256, 40, 192),
              ("forward_layer0", 256, 200, 192),
              ("serve_layer0", 16, 5, 192), ("serve_layers1_7", 16, 1, 192)]
# the edge cases: d 13 and 40 leave the last 32-channel slice ragged, L
# 17 walks three of K4's 8-step checkpoint segments
SSM_EDGE_B, SSM_EDGE_L, SSM_EDGE_D = ((1, 3, 13), (0, 1, 2, 7, 17),
                                      (13, 32, 40, 192))
# K4 launched SSM_REPEATS times at a ragged last slice over several
# segments must give the same bits each time (no atomics, no shared
# checkpoint)
SSM_RAGGED = [(2, 17, 13), (3, 33, 40), (4, 201, 13), (64, 201, 200)]
SSM_REPEATS = 5
# the other d_state the kernels are built for (8, 32, 64: 2, 8 and 16
# lanes a channel) and one they run padded to 32 (24)
SSM_STATES = (8, 24, 32, 64)
# K3/K4 against their plain versions: float32 outputs within 1e-5 relative
# + 1e-4 (fused multiply-adds, the 16 states and d's sums in another order,
# the plain version's float32 exp(delta A) and delta x B tensors; the
# state decays); the gradients summed over batch and time (d(A), d(D),
# d(dt_bias): up to 51,456 terms of either sign) within 1e-5 of their
# largest magnitude; bf16 gradients within 1e-2 (one bf16 rounding of
# float32 values that differ in their last bits)
SSM_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
SSM_SUMMED_TOL = 1e-5
SSM_ARGS = ("x", "dt", "dt_bias", "a", "bm", "c", "d_skip", "h0")
SSM_OUTPUTS = {"ssm_scan_fwd": ("y", "h_last"),
               "ssm_scan_bwd": ("dx", "d(dt)", "d(dt_bias)", "d(A)", "d(B)",
                                "d(C)", "d(D)", "d(h0)")}
SSM_SUMMED = ("d(dt_bias)", "d(A)", "d(D)")
# the SFU's exponentials (ex2 under expf, log1pf's lg2) on an H100 SXM: 16
# a clock an SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) x 132 SMs x 1.98 GHz (the data
# sheet's boost clock)
SFU_OPS_S = 16 * 132 * 1.98e9
# phase 21: RealMAN-layout recordings of 6 s (4 s crops), bz 8: 2 train
# steps an epoch, 1 valid batch
I2_FIT_TRAIN, I2_FIT_DEV, I2_FIT_BZ, I2_FIT_EPOCHS = 16, 8, 8, 2


def ssm_inputs(batch, steps, dim, dtype, device, seed, n=16):
    """The fused scan's inputs on the device as IPDnet2's init gives them
    at n states: dt_bias the inverse softplus of a dt in [1e-3, 0.1]
    (channel 0 at 25, past the softplus threshold), A = -(1..n), D = 1; x,
    dt (at 0.5), B, C normal in `dtype`; h0, dy, dh_last float32."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=device) * scale

    u = torch.rand(dim, generator=g, device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt_bias[0] = 25.0
    a = -torch.arange(1, n + 1, dtype=torch.float32,
                      device=device).expand(dim, n).contiguous()
    return {"x": randn(batch, steps, dim).to(dtype),
            "dt": randn(batch, steps, dim, scale=0.5).to(dtype),
            "dt_bias": dt_bias, "a": a,
            "bm": randn(batch, steps, n).to(dtype),
            "c": randn(batch, steps, n).to(dtype),
            "d_skip": torch.ones(dim, device=device),
            "h0": randn(batch, dim, n, scale=0.5),
            "dy": randn(batch, steps, dim),
            "dh_last": randn(batch, dim, n, scale=0.5)}


def ssm_held(what, kernel, got, want, worst, key):
    """Max |kernel - plain| of each output of `kernel` (SSM_OUTPUTS) against
    SSM_TOL by the output's dtype, or SSM_SUMMED_TOL of the largest for the
    gradients summed over batch and time; folds them into worst[key], key
    the inputs' dtype. Returns the largest."""
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(SSM_OUTPUTS[kernel], got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what} {name}: {g.dtype} {tuple(g.shape)}"
                                 f" vs plain {w.dtype} {tuple(w.shape)}")
        if not g.numel():
            continue
        diff = (g.float() - w.float()).abs()
        if name in SSM_SUMMED:
            bad = diff > SSM_SUMMED_TOL * w.abs().max()
        else:
            rtol, atol = SSM_TOL[g.dtype]
            bad = diff > atol + rtol * w.float().abs()
        if bad.any():
            raise AssertionError(f"{what} {name}: max|diff| "
                                 f"{diff.max().item():.3e} beyond the "
                                 "tolerance")
        e = diff.max().item()
        worst[key] = max(worst[key], e)
        err = max(err, e)
    return err


def phase_ssm_kernels(device, extra=()):
    """K3 and K4 against their plain versions at every scan shape of the
    IPDnet2 paths (the 16-slot tick's too), at the `extra` shapes and at
    edge cases (SSM_EDGE_*), float32 and bfloat16 inputs; at each other
    d_state of SSM_STATES (24 padded to 32) at layer 0's training shape
    and the same edge cases; and K4's bits run to run at SSM_RAGGED.
    Returns the worst errors and the checks."""
    from fnssl_tpu_torch.kernels import ssm_cuda as S

    worst = {k: {"float32": 0.0, "bfloat16": 0.0} for k in SSM_OUTPUTS}
    shapes = SSM_SHAPES + SSM_SLOT_SHAPES + list(extra)
    edges = [("edge", b, t, d) for d in SSM_EDGE_D for b in SSM_EDGE_B
             for t in SSM_EDGE_L]
    cases = [(n, b, t, d, 16) for n, b, t, d in shapes]
    cases += [(*e, 16) for e in edges]
    for n in SSM_STATES:
        cases += [(f"{name} n={n}", b, t, d, n) for name, b, t, d in
                  SSM_SHAPES[:1] + edges]
    seed, checks = 5000, 0
    for name, b, t, d, states in cases:
        for dtype in (torch.float32, torch.bfloat16):
            seed += 1
            x = ssm_inputs(b, t, d, dtype, device, seed, states)
            args = [x[k] for k in SSM_ARGS]
            n = 1 if t else 0
            key = str(dtype)[6:]
            what = f"{name} B={b} L={t} d={d} {key}"
            fwd = counted(S.launches_ssm_fwd, n, S.selective_scan_fwd, *args)
            e3 = ssm_held(f"K3 {what}", "ssm_scan_fwd", fwd,
                          S.selective_scan_fwd_plain(*args),
                          worst["ssm_scan_fwd"], key)
            bwd = counted(S.launches_ssm_bwd, n, S.selective_scan_bwd, *args,
                          x["dy"], x["dh_last"])
            e4 = ssm_held(f"K4 {what}", "ssm_scan_bwd", bwd,
                          S.selective_scan_bwd_plain(*args, x["dy"],
                                                     x["dh_last"]),
                          worst["ssm_scan_bwd"], key)
            checks += 2
            if not name.startswith("edge"):
                log(f"  {name:16s} B={b:3d} L={t:3d} d={d:3d} {key:8s} "
                    f"max|diff| K3 {e3:.2e} K4 {e4:.2e}")
            del x, args, fwd, bwd
    for b, t, d in SSM_RAGGED:
        seed += 1
        x = ssm_inputs(b, t, d, torch.float32, device, seed)
        args = [x[k] for k in SSM_ARGS] + [x["dy"], x["dh_last"]]
        first = S.selective_scan_bwd(*args)
        for _ in range(SSM_REPEATS - 1):
            for name, g, w in zip(SSM_OUTPUTS["ssm_scan_bwd"],
                                  S.selective_scan_bwd(*args), first):
                if not torch.equal(g, w):
                    raise AssertionError(f"K4 B={b} L={t} d={d} {name}: "
                                         "other bits on another launch")
        checks += 1
        del x, args, first
    torch.cuda.empty_cache()
    log(f"  {checks} checks passed at {', '.join(n for n, *_ in shapes)}; "
        f"edge cases B {SSM_EDGE_B} x L {SSM_EDGE_L} x d {SSM_EDGE_D}; "
        f"d_state {SSM_STATES} at {SSM_SHAPES[0][0]} and the edge cases; "
        f"K4 the same bits in {SSM_REPEATS} launches at {SSM_RAGGED}; "
        f"worst {json.dumps(worst)}")
    return worst, checks


def ssm_bound_terms(batch, steps, dim, itemsize, n=16):
    """The least time (ms) of K3 and of K4, the fused selective scan, for
    the bytes each must move (every input read once, every output written
    once), for its float32 operations and for its exponentials on the SFU
    (SFU_OPS_S). K3 reads x, dt, B, C (`itemsize`), dt_bias, A, D, h0 and
    writes y, h_last; per state a step it does exp(delta A), the
    recurrence's multiply-add, delta x B's product and the contraction's
    multiply-add (6 FLOPs and an exponential), per channel a step the
    softplus (2 exponentials: exp and log1p), delta x and D x (3 FLOPs).
    K4 reads those and dy, dh_last and writes dx, d(dt), d(B), d(C) and
    the float32 d(dt_bias), d(A), d(D), d(h0); it must rebuild exp(delta
    A) and h (an exponential and 4 FLOPs a state a step) and walk back
    (gh, d(da) da, d(B), d(C), s_A, s_B, d(A), the carry: 14 FLOPs); n
    states."""
    big, chan = batch * steps * dim * n, batch * steps * dim
    bc, state = batch * steps * n, batch * dim * n * 4
    params = (2 * dim + dim * n) * 4
    k3 = ((2 * chan + 2 * bc) * itemsize + params + state + chan * 4
          + state, 6 * big + 3 * chan, big + 2 * chan)
    k4 = ((2 * chan + 2 * bc) * itemsize + params + state + chan * 4 + state
          + (2 * chan + 2 * bc) * itemsize + params + state,
          18 * big + 6 * chan, big + 2 * chan)
    return tuple({"bytes": nbytes / HBM_BYTES_S * 1e3,
                  "operations": flops / FP32_FLOP_S * 1e3,
                  "exponentials": exps / SFU_OPS_S * 1e3}
                 for nbytes, flops, exps in (k3, k4))


def phase_ssm_times(device, shapes=SSM_SHAPES, n=16):
    """K3 and K4 at each scan shape of the IPDnet2 paths (n states),
    float32 and bfloat16 inputs: the card's time of a launch from a device
    trace (device_ms; CUDA events around back-to-back calls would read the
    host's enqueue at the serve and slot shapes), the host's enqueue
    beside it, their bound and their plain versions (float32, CUDA
    events). No PyTorch call computes a selective scan: there is no
    library time."""
    from fnssl_tpu_torch.kernels import ssm_cuda as S

    rows = []
    for name, b, t, d in shapes:
        row = {"shape": name, "B": b, "L": t, "d": d, "n": n}
        for dtype in (torch.float32, torch.bfloat16):
            x = ssm_inputs(b, t, d, dtype, device, 7, n)
            args = [x[k] for k in SSM_ARGS]
            key = str(dtype)[6:]
            k3 = lambda: S.selective_scan_fwd(*args)          # noqa: E731
            k4 = lambda: S.selective_scan_bwd(                # noqa: E731
                *args, x["dy"], x["dh_last"])
            row[f"k3_ms_{key}"] = device_ms(k3, 20)
            row[f"k4_ms_{key}"] = device_ms(k4, 20)
            row[f"k3_enqueue_ms_{key}"] = enqueue_ms(k3, 20)
            row[f"k4_enqueue_ms_{key}"] = enqueue_ms(k4, 20)
            k3, k4 = ssm_bound_terms(b, t, d, dtype.itemsize, n)
            row[f"k3_bound_terms_{key}"], row[f"k4_bound_terms_{key}"] = \
                k3, k4
            if dtype == torch.float32:
                row["k3_plain_ms"] = cuda_ms(
                    lambda: S.selective_scan_fwd_plain(*args), 3)
                row["k4_plain_ms"] = cuda_ms(
                    lambda: S.selective_scan_bwd_plain(
                        *args, x["dy"], x["dh_last"]), 3)
            del x, args
        k3b, k4b = bound(row["k3_bound_terms_float32"]), bound(
            row["k4_bound_terms_float32"])
        row["k3_bound_ms"], row["k4_bound_ms"] = k3b[0], k4b[0]
        rows.append(row)
        log(f"  {name:16s} B={b:3d} L={t:3d} d={d} n={n}: K3 "
            f"{row['k3_ms_float32']:.4f} ms ({row['k3_ms_bfloat16']:.4f}; "
            f"enqueue {row['k3_enqueue_ms_float32']:.4f}) bound "
            f"{k3b[0]:.4f} ({k3b[1]}) plain {row['k3_plain_ms']:.2f}; K4 "
            f"{row['k4_ms_float32']:.4f} ({row['k4_ms_bfloat16']:.4f}; "
            f"enqueue {row['k4_enqueue_ms_float32']:.4f}) bound "
            f"{k4b[0]:.4f} ({k4b[1]}) plain {row['k4_plain_ms']:.2f}")
    torch.cuda.empty_cache()
    return rows


def ipdnet2_batch(nb, seed):
    """The JAX package's IPDnet2 bench batch (bench.py:138-176): nb scenes
    of 4 s of 5-channel noise, 2 tracks at uniform azimuths and ranges,
    unit VAD, the 5-mic subset's positions."""
    from fnssl_tpu_torch.data.arrays import audiowu_high_array_geometry
    from fnssl_tpu_torch.train.tasks import IPDNET2_MIC_IDS

    rng = np.random.default_rng(seed)
    mic = audiowu_high_array_geometry()[list(IPDNET2_MIC_IDS)]
    nt2 = int(I2_T_S * 10)
    return {"mic_sig": rng.standard_normal(
                (nb, int(I2_T_S * FS), 5)).astype(np.float32),
            "azi_deg": rng.uniform(0, 180, (nb, nt2, 2)).astype(np.float32),
            "distance": rng.uniform(0.5, 3.0, (nb, nt2, 2)).astype(
                np.float32),
            "vad": np.ones((nb, nt2, 2), np.float32),
            "mic_pos": np.broadcast_to(mic, (nb,) + mic.shape).astype(
                np.float32).copy()}


def ipdnet2_setup(seed, nb, device, precision="fp32", cfg=None, mesh=None):
    """(state, step, batch) of make_ipdnet2_task at `cfg` (default
    SpatialNetConfig()) on `device`: weights from `seed`, AdamW 5e-4 /
    gamma 0.975 with a clip of 5, the bench batch on the device; sharded
    over a 2-D `mesh` when one is given (the whole global batch)."""
    from fnssl_tpu_torch.models.spatialnet import SpatialNet
    from fnssl_tpu_torch.train import step as S
    from fnssl_tpu_torch.train import tasks as TK

    task = TK.make_ipdnet2_task(cfg, precision=precision, device=device,
                                feats_sharding=mesh)
    model = SpatialNet(task.cfg, device=device,
                       generator=torch.Generator().manual_seed(seed))
    tx = S.make_optimizer("adamw", I2_LR, 0.975, 1, grad_clip=5.0)
    step = S.make_train_step(task.loss_fn, tx, mesh=mesh)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in ipdnet2_batch(nb, seed).items()}
    return S.init_train_state(model, tx), step, batch


# the grouped convs over frequency whose outputs pass a per-channel PReLU:
# the gates of phase 19's parity step
I2_GATES = tuple(f"layers.{i}.fconv{j}.1" for i in range(8) for j in (1, 2))


def phase_ipdnet2_parity(seed, device):
    """The task's preprocess (STFT center=True, forgetting norm, DPIPD2
    targets) on the card against the CPU, then phase 7's check of one
    fp32 train step (nb=I2_PARITY_NB x 4 s), the CPU step taking the
    card's PReLU gates (I2_GATES): the PReLU's slope switches from 1 to
    0.25 at 0, and on the CPU (nb 2) a 1e-7 relative perturbation of
    layer 0's first LayerNorm output, which moves conv outputs within
    rounding of 0 across it, moves layers.0.full.weight's gradient by
    7.7e-4 of its largest value (a perturbation of any other output
    tried, ~3e-7)."""
    from fnssl_tpu_torch.train import tasks as TK

    batch = ipdnet2_batch(I2_PARITY_NB, seed)
    out = {}
    for dev in (device, torch.device("cpu")):
        task = TK.make_ipdnet2_task(device=dev)
        feats, gt = task.preprocess(*(torch.as_tensor(batch[k], device=dev)
                                      for k in TK.IPDNET2_KEYS))
        out[dev.type] = (feats.cpu(), gt["ipd"].cpu())
    feats_err = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    ipd_err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    log(f"  preprocess card vs CPU: features max|diff| {feats_err:.2e} "
        f"(max|x| {out['cpu'][0].abs().max().item():.2f}), targets "
        f"max|diff| {ipd_err:.2e}")
    # features atol 1e-5, the CPU tests' tolerance against JAX; targets
    # 1e-4: their phase 2*pi*f*(d2 - d1)/c takes the difference of two
    # float32 distances of ~3 m, whose ulp (2.4e-7 m) is 3.5e-5 rad at 8 kHz
    if not (feats_err <= 1e-5 and ipd_err <= 1e-4):
        raise AssertionError("the preprocess on the card disagrees with the"
                             " CPU beyond 1e-5 (features) or 1e-4 (targets)")
    res = phase_train_parity(
        seed, device, functools.partial(ipdnet2_setup, seed, I2_PARITY_NB),
        lr=I2_LR, want=I2_STEP_LAUNCHES, gates=I2_GATES)
    return {"preprocess_features_max_abs_diff": feats_err,
            "preprocess_targets_max_abs_diff": ipd_err, **res}


def phase_ipdnet2_train(seed, device):
    """The JAX package's train cell (nb 16 x 4 s, fp32 then the bf16
    policy: 1 warm + 5 timed steps) and forward cell (nb 16, nt 200, fp32,
    warm, CUDA events); one fp32 train step under torch.profiler."""
    from fnssl_tpu_torch.models.spatialnet import SpatialNet

    rows = {}
    counts = launch_counters()
    for c in counts:
        c.reset()
    steps = 0
    for precision in ("fp32", "bf16"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, step, batch = ipdnet2_setup(seed, I2_NB, device, precision)
        state, ms, losses = timed_steps(state, step, batch, None,
                                        TIMED_STEPS)
        steps += 1 + TIMED_STEPS
        row = {"ms_mean": float(ms.mean()),
               "ms_p90": float(np.percentile(ms, 90)), "ms": ms.tolist(),
               "audio_s_per_s": I2_NB * I2_T_S / (ms.mean() / 1e3),
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "losses": losses}
        if not np.isfinite(losses).all():
            raise AssertionError(f"ipdnet2 {precision}: losses {losses}")
        rows[precision] = row
        log(f"  ipdnet2 nb={I2_NB} x {I2_T_S} s {precision}: step ms mean "
            f"{row['ms_mean']:.2f} p90 {row['ms_p90']:.2f} over "
            f"{TIMED_STEPS} steps; {row['audio_s_per_s']:.1f} s of audio a "
            f"second; peak {row['peak_bytes'] / 2**30:.2f} GiB; losses "
            + ", ".join(f"{v:.6f}" for v in losses))
        del state, step, batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = SpatialNet(device=device,
                     generator=torch.Generator().manual_seed(seed)).eval()
    x = torch.randn(I2_NB, 10, 256, I2_FWD_NT, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: net(x), 10)
    fwd_launches = I2_LAUNCHES * 12
    rows["forward_fp32"] = {
        "ms": fwd_ms, "audio_s_per_s": I2_NB * I2_FWD_NT * 320 / FS
        / (fwd_ms / 1e3), "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"  forward nb={I2_NB} nt={I2_FWD_NT} fp32: {fwd_ms:.2f} ms, "
        f"{rows['forward_fp32']['audio_s_per_s']:.1f} s of audio a second,"
        f" peak {rows['forward_fp32']['peak_bytes'] / 2**30:.2f} GiB")
    del net, x
    launched = [c.value for c in counts]
    want = [steps * n for n in I2_STEP_LAUNCHES]
    want[4] += fwd_launches
    if launched != want:
        raise AssertionError(f"IPDnet2 training launched {COUNTED} "
                             f"{launched} for {steps} steps and the "
                             f"forwards, expected {want}")
    log(f"  launches {COUNTED} {launched} = {steps} steps x "
        f"{I2_STEP_LAUNCHES} and {fwd_launches} K3 of the timed forwards")
    torch.cuda.empty_cache()
    state, step, batch = ipdnet2_setup(seed, I2_NB, device)
    state, _ = step(state, batch)
    prof = profile_step(lambda: step(state, batch))
    if not prof["busy_ms"]:
        raise AssertionError("the profiler saw no kernel on the card")
    log(f"  profile of one fp32 ipdnet2 step: wall {prof['wall_ms']:.2f} "
        f"ms, busy {prof['busy_ms']:.2f} ms, idle share "
        f"{prof['idle_share']:.2%}; busy by group " + ", ".join(
            f"{g} {ms:.2f} ms ({ms / prof['busy_ms']:.1%})"
            for g, ms in prof["groups_ms"].items()))
    for k in prof["top"]:
        log(f"    {k['ms']:9.3f} ms  {k['kernel']}")
    rows["profile_fp32"] = prof
    del state, step, batch
    torch.cuda.empty_cache()
    return rows, dict(zip(COUNTED, launched))


# IPDnet2 at SpatialNetConfig(attention="mamba(32,4)"), every other width
# published: the fused scan at d_state 32. Phase 19's parity step, phase
# 20's train cell (1 warm + WIDE_STEPS timed steps, fp32 then bf16), and K3
# and K4 at its scan shapes
I2_D32_ATTENTION = "mamba(32,4)"
I2_D32_SHAPES = [("d32_train_layer0", 256, 201, 192),
                 ("d32_train_layers1_7", 256, 40, 192)]


def phase_ipdnet2_d32(seed, device):
    """IPDnet2 with attention="mamba(32,4)": phase 19's fp32 parity step
    (nb I2_PARITY_NB x 4 s, the card's PReLU gates), 16 K3 and 16 K4 a
    step; phase 20's cell nb I2_NB x 4 s, fp32 then bf16 (ms a step, mean
    and p90, peak memory, exact launches); K3 and K4 a launch at its scan
    shapes beside their bounds and plain versions."""
    from fnssl_tpu_torch.models.spatialnet import SpatialNetConfig

    cfg = SpatialNetConfig(attention=I2_D32_ATTENTION)
    if cfg.mamba_cfg.d_state != 32:
        raise AssertionError(f"{I2_D32_ATTENTION}: d_state "
                             f"{cfg.mamba_cfg.d_state}")
    report = {"parity": phase_train_parity(
        seed, device, functools.partial(ipdnet2_setup, seed, I2_PARITY_NB,
                                        cfg=cfg),
        lr=I2_LR, want=I2_STEP_LAUNCHES, gates=I2_GATES)}
    counts = launch_counters()
    for c in counts:
        c.reset()
    for precision in ("fp32", "bf16"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, step, batch = ipdnet2_setup(seed, I2_NB, device, precision,
                                           cfg=cfg)
        state, ms, losses = timed_steps(state, step, batch, None, WIDE_STEPS)
        if not np.isfinite(losses).all():
            raise AssertionError(f"{I2_D32_ATTENTION} {precision}: losses "
                                 f"{losses}")
        report[precision] = {
            "ms_mean": float(ms.mean()),
            "ms_p90": float(np.percentile(ms, 90)), "ms": ms.tolist(),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "losses": losses}
        log(f"  {I2_D32_ATTENTION} nb={I2_NB} x {I2_T_S} s {precision}: step "
            f"ms mean {report[precision]['ms_mean']:.2f} p90 "
            f"{report[precision]['ms_p90']:.2f} over {WIDE_STEPS} steps; peak "
            f"{report[precision]['peak_bytes'] / 2**30:.2f} GiB; losses "
            + ", ".join(f"{v:.6f}" for v in losses))
        del state, step, batch
    torch.cuda.empty_cache()
    steps = 2 * (1 + WIDE_STEPS)
    launched = [c.value for c in counts]
    want = [steps * n for n in I2_STEP_LAUNCHES]
    if launched != want:
        raise AssertionError(f"{I2_D32_ATTENTION} training launched {COUNTED} "
                             f"{launched} for {steps} steps, expected {want}")
    log(f"  launches {COUNTED} {launched} = {steps} steps x "
        f"{I2_STEP_LAUNCHES}")
    report["scans"] = phase_ssm_times(device, I2_D32_SHAPES, n=32)
    total = [a + b for a, b in zip(launched, report["parity"]["launches"])]
    return report, dict(zip(COUNTED, total))


def write_realman(root, recordings, seed):
    """A RealMAN-layout corpus of `recordings` 6 s recordings (the 5
    channels of the mic subset, a dp_speech copy, one static source a
    third, the rest moving with 60-value 10 Hz streams) and 5 s of noise,
    as wav; returns the targets CSV."""
    from fnssl_tpu_torch.train.tasks import IPDNET2_MIC_IDS
    from fnssl_tpu_torch.utils.audio_io import write_audio

    rng = np.random.default_rng(seed)
    for sub in ("ma_speech", "dp_speech", "noise"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    rows = ["filename,angle(°),distance"]
    for rec in range(recordings):
        src = rng.standard_normal(6 * FS + 64).astype(np.float32) * 0.3
        delay = int(rng.integers(-6, 7))
        for k, ch in enumerate(IPDNET2_MIC_IDS):
            a = 32 + k * delay
            write_audio(str(root / "ma_speech" / f"rec{rec}_CH{ch}.wav"),
                        src[a: a + 6 * FS], FS)
        write_audio(str(root / "dp_speech" / f"rec{rec}.wav"),
                    src[32: 32 + 6 * FS], FS)
        if rec % 3 == 0:
            rows.append(f"rec{rec}.wav,{rng.integers(0, 180)}.0,"
                        f"{rng.uniform(0.5, 3):.2f}")
        else:
            a0 = int(rng.integers(0, 120))
            angs = ",".join(str(a0 + i) for i in range(60))
            diss = ",".join(f"{1.0 + 0.01 * i:.2f}" for i in range(60))
            rows.append(f'rec{rec}.wav,"{angs}","{diss}"')
    nz = rng.standard_normal((5 * FS, 5)).astype(np.float32) * 0.1
    for k, ch in enumerate(IPDNET2_MIC_IDS):
        write_audio(str(root / "noise" / f"amb_CH{ch}.wav"), nz[:, k], FS)
    csv = root / "targets.csv"
    csv.write_text("\n".join(rows) + "\n", encoding="utf-8")
    return csv


def phase_ipdnet2_fit(seed, device, card):
    """The user's IPDnet2 loop through the CLI on the card: a synthetic
    RealMAN-layout corpus as wav, `fit --model ipdnet2` 2 epochs, `test`,
    `test --best` (the valid items with the fit's seed: each test loss
    equals the valid loss of the epoch it restored) and `serve` from the
    fit's best_model.tar."""
    report = {"card": card}
    launches = {}
    train_steps = I2_FIT_EPOCHS * (I2_FIT_TRAIN // I2_FIT_BZ)
    valid = -(-I2_FIT_DEV // I2_FIT_BZ)

    def want(train, evals):
        return [0, 0, 0, 0, I2_LAUNCHES * (train + evals),
                I2_LAUNCHES * train, 0, 0]

    with tempfile.TemporaryDirectory() as tmp:
        train_csv = write_realman(Path(tmp) / "train", I2_FIT_TRAIN, seed)
        dev_csv = write_realman(Path(tmp) / "dev", I2_FIT_DEV, seed + 1)
        log_dir = Path(tmp) / "runs"
        # the fit validates with its one --realman-noise dir: the test
        # reads the same noise, so that it reads the same items
        dev = ["--realman-csv", str(dev_csv), "--realman-noise",
               str(Path(tmp) / "train" / "noise"), "--realman-ext", "wav"]
        common = ["--model", "ipdnet2", "--bz", str(I2_FIT_BZ), "--seed",
                  str(seed), "--log-dir", str(log_dir)]
        ma = str(Path(tmp) / "train" / "ma_speech") + "/"
        dev_ma = str(Path(tmp) / "dev" / "ma_speech") + "/"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fit, _, launches["fit"], fit_s = counted_cli(
            ["fit", *common, "--train-dir", ma, "--valid-dir", dev_ma,
             "--epochs", str(I2_FIT_EPOCHS), "--realman-csv",
             str(train_csv), "--realman-valid-csv", str(dev_csv),
             "--realman-noise", str(Path(tmp) / "train" / "noise"),
             "--realman-ext", "wav"], want(train_steps,
                                           I2_FIT_EPOCHS * valid),
            f"fit ipdnet2 ({I2_FIT_EPOCHS} epochs of {I2_FIT_TRAIN} items)")
        report["fit"], report["fit_s"] = fit, fit_s
        report["peak_bytes"] = torch.cuda.max_memory_allocated()
        if not (np.isfinite(fit["final_train"])
                and np.isfinite(fit["final_valid"])):
            raise AssertionError(f"fit ipdnet2: losses {fit}")
        for f in [f"ckpt/epoch_{e}.tar" for e in range(I2_FIT_EPOCHS)] + [
                "ckpt/index.json", "best_model.tar", "config.json"]:
            if not (log_dir / f).exists():
                raise AssertionError(f"fit ipdnet2: no {f}")
        test, _, launches["test"], _ = counted_cli(
            ["test", *common, "--data-dir", dev_ma, *dev], want(0, valid),
            "test ipdnet2")
        if not abs(test["loss"] - fit["final_valid"]) <= 1e-6:
            raise AssertionError(f"test ipdnet2: loss {test['loss']} vs the "
                                 f"fit's final valid {fit['final_valid']}")
        if not all(np.isfinite(test[k]) for k in ("ACC", "MAE")):
            raise AssertionError(f"test ipdnet2: metrics {test}")
        report["test"] = test
        best, out, launches["test_best"], _ = counted_cli(
            ["test", *common, "--data-dir", dev_ma, *dev, "--best"],
            want(0, valid), "test --best ipdnet2")
        index = json.loads((log_dir / "ckpt/index.json").read_text())
        best_epoch = min(sorted(index, key=int), key=lambda e: index[e])
        if f"resumed from epoch {best_epoch}" not in out or not abs(
                best["loss"] - index[best_epoch]) <= 1e-6:
            raise AssertionError(f"test --best ipdnet2: {best}, index "
                                 f"{index}")
        report["test_best"] = best
        report["epochs"] = epoch_stats(log_dir)
        report["serve_lines"], launches["serve_after_fit"] = serve_after_fit(
            "ipdnet2", log_dir, make_audio(seed + 400, 2, 5))
    for e, st in enumerate(report["epochs"]):
        log(f"  ipdnet2 epoch {e}: {st['epoch_s']:.3f} s of train steps "
            f"({int(st['steps'])} steps, {st['ms_per_step']:.1f} ms a step),"
            f" of it {st['first_batch_wait_s']:.3f} s waiting for the first "
            f"batch; {card}")
    log(f"  ipdnet2: fit {fit_s:.2f} s, test loss {test['loss']:.6f} = valid"
        f" {fit['final_valid']:.6f}, test --best {best['loss']:.6f} (epoch "
        f"{best_epoch}), ACC {test['ACC']:.4f} MAE {test['MAE']:.2f}, peak "
        f"{report['peak_bytes'] / 2**30:.2f} GiB")
    total = [sum(v[i] for v in launches.values())
             for i in range(len(COUNTED))]
    report["launches"] = launches
    log(f"  IPDnet2 fit path launches {COUNTED} {total}")
    return report, dict(zip(COUNTED, total))


# phases 22-25: the inference entry points, at the published widths. K1 (or
# K3) launches of one forward or chunk step, in COUNTED's order
INFER_MODELS = ("fnssl", "fnssl_doa", "ipdnet", "ipdnet2")
FORWARD_LAUNCHES = {"fnssl": CHUNK_LAUNCHES["fnssl"],
                    "fnssl_doa": CHUNK_LAUNCHES["fnssl"],
                    "ipdnet": CHUNK_LAUNCHES["ipdnet"],
                    "ipdnet2": CHUNK_LAUNCHES["ipdnet2"]}
STREAM_BLOCK = int(FS * 0.192)            # `cli stream`'s default push
# serve --slots: 16 slots, 16 concurrent TCP connections of SLOT_AUDIO_S
# (15 chunk steps; 30 for IPDnet2: each connection's dedicated reference
# stream runs on the host's time), ticks timed a tier
SLOTS, SLOT_MODELS, TIER_ITERS = 16, ("fnssl", "ipdnet", "ipdnet2"), 20
SLOT_AUDIO_S = 3.0
# the same connections through the eager per-connection serve path, as the
# yardstick of the pool's aggregate rate: FN-SSL's alone, for the script's
# time limit (IPDnet's takes 13 s, IPDnet2's ~42 ms eager step would add
# half a minute)
EAGER_BASELINE = ("fnssl",)
# the recurrences of a 16-slot tick: (name, T, B, H, I, ndir), B = 16 x
# a stream's rows (12 frames full band, 256 bins narrow band)
SLOT_SHAPES = [("slots16_fullband", 256, 16 * 12, 128, 256, 2),
               ("slots16_narrowband", 12, 16 * 256, 256, 256, 1),
               ("ipdnet_slots16_fullband", 256, 16 * 12, 64, 4, 2),
               ("ipdnet_slots16_narrowband", 12, 16 * 256, 128, 132, 1)]
# the shapes where lstm_wave.cu is held to beat lstm_cluster.cu (phase 5):
# FN-SSL's narrow band (T, B, H) in training and in the 16-slot tick
WAVE_TARGETS = [("train_narrowband", 298, TRAIN_NB * 256, 256, 1),
                ("slots16_narrowband", 12, SLOTS * 256, 256, 1),
                ("dp_rank_narrowband", 298, 8 * 256, 256, 1),  # DP_NB // 2
                ("train_fullband", 256, TRAIN_NB * 298, 128, 2)]
# and IPDnet2's scans of a 16-slot tick: B = 16 x 16 compressed bins
SSM_SLOT_SHAPES = [("slots16_layer0", 256, 5, 192),
                   ("slots16_layers1_7", 256, 1, 192)]
# phase 25: (model, modes) of the artifacts exported for the card; the
# CPU_TOO artifact also carries a CPU program (the ops' plain versions)
EXPORT_PLATFORM, CPU_TOO = "cuda", ("fnssl", "stream")
EXPORTS = (("fnssl", ("forward", "stream")), ("ipdnet", ("forward", "stream")),
           ("ipdnet2", ("forward", "stream")), ("variable_ipdnet", ("forward",)))


def spectra_of(model, pred, task):
    """(tracks, frames, grid): the scores each decoded DOA is the argmax
    of (the IPD decodes' spatial spectra per track, fnssl_doa's logits)."""
    from fnssl_tpu_torch.eval.decode import spatial_spectrum
    from fnssl_tpu_torch.eval.pred_doa import PredDOA, PredDOAMultiTrack

    pred = pred.float().cpu()
    nt = pred.shape[1]
    if model == "fnssl_doa":
        return pred[0][None].numpy()
    if model == "fnssl":
        res = PredDOA(device="cpu").predgt2doa(pred)[0]
        return res["spatial_spectrum"].reshape(1, nt, -1).numpy()
    dec = PredDOAMultiTrack(task.dpipd.mic_location, max_track=2,
                            device="cpu")
    return torch.stack([spatial_spectrum(pred[..., k], dec.template)
                        .reshape(nt, -1) for k in range(pred.shape[-1])]
                       ).numpy()


def same_or_tie(label, got, want, spectra):
    """Decoded DOAs (degrees; (frames, 2, tracks)) equal to 1e-3, or at an
    exact tie (1e-3) at the top of that track's scores. Returns the
    frames at a tie."""
    ties = 0
    for t in range(want.shape[0]):
        for k in range(want.shape[-1]):
            if np.allclose(got[t, ..., k], want[t, ..., k], atol=1e-3):
                continue
            top2 = np.sort(spectra[k, t])[-2:]
            if top2[1] - top2[0] > 1e-3:
                raise AssertionError(f"{label} frame {t} track {k}: "
                                     f"{got[t, ..., k]} vs {want[t, ..., k]}")
            ties += 1
    return ties


def quiet(fn, *args, **kwargs):
    """fn(*args) with its standard output (the CLI's warnings) dropped."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def phase_predict(seed, device, tmp):
    """`cli predict` of each model on a 5 s wav on the card (fresh weights
    from `seed`; 5 channels for IPDnet2): exact launches (K1 or K3 at B =
    1 over the whole wav); the raw output within 1e-3 of the same weights'
    plain run on the CPU and the dumped DOAs equal to the CPU's decode
    but at exact ties; and `ipd_baseline` (host only, no launch)."""
    from fnssl_tpu_torch.cli.main import _task_for, load_model, predict
    from fnssl_tpu_torch.utils.audio_io import write_audio

    report, totals = {}, [0] * len(COUNTED)
    for model in INFER_MODELS + ("ipd_baseline",):
        sig = make_audio(seed + 300, 3, SERVE_NCH.get(model, 2))
        wav, out = tmp / f"predict_{model}.wav", tmp / f"predict_{model}"
        write_audio(str(wav), sig, FS)
        want = FORWARD_LAUNCHES.get(model, [0] * len(COUNTED))
        res, _, launched, secs = counted_cli(
            ["predict", "--model", model, "--wav", str(wav), "--out",
             str(out), "--seed", str(seed), "--log-dir", str(tmp / "none")],
            want, f"predict {model}")
        totals = [a + b for a, b in zip(totals, launched)]
        doa = np.load(out / "doa_est.npy")
        if not (np.isfinite(doa).all() and doa.shape[1] == res["frames"] > 0):
            raise AssertionError(f"predict {model}: dump {doa.shape}, {res}")
        if model == "ipd_baseline":
            report[model] = {"frames": res["frames"], "seconds": secs}
            log(f"  ipd_baseline: {res['frames']} frames, finite, "
                f"{secs:.2f} s on the host")
            continue
        task, ctask = _task_for(model, device), _task_for(model, "cpu")
        card = quiet(load_model, model, str(tmp / "none"), seed, device,
                     cfg=task.cfg)
        cpu = quiet(load_model, model, str(tmp / "none"), seed, "cpu",
                    cfg=ctask.cfg)
        got, _ = predict(model, card, task, sig, device)
        ref, dec = predict(model, cpu, ctask, sig, "cpu")
        err = (got.float().cpu() - ref.float()).abs().max().item()
        if not err <= 1e-3:
            raise AssertionError(f"predict {model}: output max|diff| {err} "
                                 "vs the CPU > 1e-3")
        ties = same_or_tie(f"predict {model}", doa[0],
                           np.degrees(dec["doa"].numpy())[0],
                           spectra_of(model, ref, ctask))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(model, card, task, sig, device)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        report[model] = {"frames": res["frames"], "max_abs_err": err,
                         "ties": ties, "cli_seconds": secs,
                         "predict_ms": ms, "launches": launched}
        log(f"  predict {model}: {res['frames']} frames, output max|diff| "
            f"vs CPU {err:.3e}, DOAs equal (ties {ties}); a warm predict "
            f"(front end, forward, decode) {ms:.2f} ms for "
            f"{SERVE_AUDIO_S} s of audio")
    return report, dict(zip(COUNTED, totals))


def phase_stream(seed, device, tmp):
    """`cli stream` of each causal model on the card (192 ms pushes of a
    5 s wav): exact launches, its RTF, and each chunk's decoded DOA and
    VAD equal to the serve path's session on the same audio and pushes."""
    from fnssl_tpu_torch.cli.main import build_parser, build_server
    from fnssl_tpu_torch.utils.audio_io import write_audio

    report, totals = {}, [0] * len(COUNTED)
    for model in INFER_MODELS:
        sig = make_audio(seed + 310, -3, SERVE_NCH.get(model, 2))
        wav, out = tmp / f"stream_{model}.wav", tmp / f"stream_{model}"
        write_audio(str(wav), sig, FS)
        steps = chunk_steps(model)
        res, _, launched, secs = counted_cli(
            ["stream", "--model", model, "--wav", str(wav), "--out",
             str(out), "--seed", str(seed), "--log-dir", str(tmp / "none")],
            [n * steps for n in FORWARD_LAUNCHES[model]], f"stream {model}")
        totals = [a + b for a, b in zip(totals, launched)]
        server, _ = quiet(build_server, build_parser().parse_args(
            ["serve", "--model", model, "--port", "0", "--seed", str(seed),
             "--log-dir", str(tmp / "none")]))
        server._sock.close()
        loc, decode = server.session_factory()
        doas, vads = [], []
        for start in range(0, sig.shape[0], STREAM_BLOCK):
            for chunk in loc.push(sig[start: start + STREAM_BLOCK]):
                r = decode(chunk)
                doas.append(np.degrees(r["doa"].cpu().numpy())[0])
                vads.append(r["vad_sources"].cpu().numpy()[0])
        doa, vad = np.load(out / "doa_est.npy"), np.load(out / "vad_est.npy")
        if not (len(doas) == steps and np.array_equal(
                doa, np.concatenate(doas)) and np.allclose(
                    vad, np.concatenate(vads), rtol=0, atol=1e-6)):
            raise AssertionError(f"stream {model}: {len(doas)} chunks; the "
                                 "dump differs from the serve path's")
        report[model] = {"chunk_steps": steps, "rtf": res["rtf"],
                         "cli_seconds": secs, "launches": launched}
        log(f"  stream {model}: {steps} chunk steps, RTF {res['rtf']}, "
            "each chunk's DOA and VAD equal to the serve session's")
    return report, dict(zip(COUNTED, totals))


def guarded_trace(fn, *args, retry=None):
    """fn(*args) under torch.profiler, device activity only: its result,
    the device events (kernels, memsets, copies) it made and the records
    the trace lost. A trace may lose its first records (seen on the H100,
    only ever a run of them at its head: one K1 of a tier-1 replay in
    three full runs, and once all 256 spin kernels of an earlier, shorter
    guard), so the window opens TRACE_SETTLE_S[0] after the profiler starts,
    with TRACE_GUARD spin kernels, and fails unless some of them were
    recorded: what was lost came before fn. A trace that kept none of
    them (seen once on the H100, all 2048, in a run of a few hundred
    traces) says nothing of fn's records: with `retry`, a function that
    undoes what fn changed, it is taken again after retry(), settling
    longer each time, up to len(TRACE_SETTLE_S) tries in all."""
    from torch.profiler import ProfilerActivity, profile

    for attempt, settle in enumerate(TRACE_SETTLE_S, 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(settle)
            for _ in range(TRACE_GUARD):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            out = fn(*args)
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        guard = sum("spin_kernel" in e.name for e in events)
        if 0 < guard <= TRACE_GUARD:
            break
        if guard or retry is None or attempt == len(TRACE_SETTLE_S):
            raise AssertionError(f"the trace kept {guard} of its "
                                 f"{TRACE_GUARD} guard kernels (try "
                                 f"{attempt} of {len(TRACE_SETTLE_S)})")
        log(f"  (a trace kept none of its {TRACE_GUARD} guard kernels; "
            f"tracing again after {TRACE_SETTLE_S[attempt]} s)")
        retry()
    return (out, [e for e in events if "spin_kernel" not in e.name],
            TRACE_GUARD - guard)


def traced_launches(fn, *args, retry=None):
    """fn(*args) in a guarded trace (`retry` as there): its result and the
    kernels of COUNTED that the card ran, counted by name (CUPTI records
    every kernel node of a CUDA graph replay, which calls no wrapper and
    moves no launch counter). A loss at the trace's head is logged."""
    out, events, lost = guarded_trace(fn, *args, retry=retry)
    if lost:
        log(f"  (a trace lost its first {lost} records, guard kernels of "
            f"{TRACE_GUARD})")
    counts = [0] * len(TRACED)
    for e in events:
        i = traced_index(e.name)
        if i is not None:
            counts[i] += 1
    return out, counts


def tick_launches(model, slots):
    """Launches (COUNTED's order) of one tick of `slots` streams: one
    chunk step of each, batched (12 frames and 256 bins a stream; the
    narrow band reaches lstm_wave.cu at FN-SSL's 16-slot tier)."""
    if model == "fnssl":
        return k1_split([(256, 12 * slots, 128, 2, 3),
                         (12, 256 * slots, 256, 1, 3)])
    if model == "ipdnet":
        return k1_split([(256, 12 * slots, 64, 2, 2),
                         (12, 256 * slots, 128, 1, 2)])
    return CHUNK_LAUNCHES[model]


def tier_checks(stepper, rows, feat_shape, device, launches):
    """Each tier of a warm pool: the ms a tick (host clock around
    step_slots: features up, one replay, outputs down; TIER_ITERS ticks of
    every slot of the tier active), and one replay, traced, against the
    same tier run eagerly on the card from the same pool state (outputs
    and state within 1e-6). The traced replay of tier s must run
    `launches(s)` (one tick's, COUNTED's order), as many as the eager
    tier's wrappers launched. Returns the tiers' numbers and each replay's
    traced kernels."""
    rng = np.random.default_rng(0)
    out, per_tick = {}, {}
    counters = launch_counters()
    for s in stepper.tier_sizes:
        ids = np.arange(s)
        feats = rng.standard_normal((s * rows,) + feat_shape).astype(
            np.float32)
        reset = np.zeros(s, bool)
        ms = []
        for _ in range(TIER_ITERS):
            t0 = time.perf_counter()
            stepper.step_slots(ids, feats, reset)
            ms.append((time.perf_counter() - t0) * 1e3)
        before = [leaf.clone() for leaf in stepper._state]

        def restore():
            for leaf, b in zip(stepper._state, before):
                leaf.copy_(b)

        # a trace that recorded none of the replay's kernels (seen once, at
        # IPDnet2's tier 1, its guard kept) is taken again from the same
        # state; the count must still equal launches(s)
        for attempt in range(len(TRACE_SETTLE_S)):
            got, per_tick[s] = traced_launches(
                stepper.step_slots, ids, feats, reset, retry=restore)
            if any(per_tick[s]) or not any(launches(s)):
                break
            log(f"  (tier {s}: the traced replay recorded none of its "
                f"kernels; tracing it again, try {attempt + 2})")
            restore()
        after = [leaf.clone() for leaf in stepper._state]
        restore()
        n0 = [c.value for c in counters]
        want = stepper._run_tier(
            s, torch.as_tensor(feats, device=device),
            torch.as_tensor(ids, device=device),
            torch.zeros(s, dtype=torch.bool, device=device),
            torch.ones(s, dtype=torch.bool, device=device)).cpu()
        eager = [c.value - n for c, n in zip(counters, n0)]
        if per_tick[s] != launches(s) or eager != launches(s):
            raise AssertionError(f"tier {s}: a replay ran {per_tick[s]} "
                                 f"(trace), the eager tier {eager}, "
                                 f"expected {launches(s)}")
        err = max([(got - want).abs().max().item()] + [
            (a - b).abs().max().item()
            for a, b in zip(after, stepper._state)])
        if not err <= 1e-6:
            raise AssertionError(f"tier {s}: replay vs eager max|diff| {err}")
        ms = np.asarray(ms)
        out[s] = {"ms_mean": float(ms.mean()),
                  "ms_p90": float(np.percentile(ms, 90)),
                  "replay_vs_eager_max_abs_err": err}
    return out, per_tick


def concurrent_connections(server, audios):
    """One TCP connection a recording, all at once (each sends its audio
    as fast as the server reads it), with every launch counter set to 0
    just before and read just after. Returns the replies, the launches
    (COUNTED's order) and the wall seconds."""

    from fnssl_tpu_torch.runtime.server import stream_client

    replies = [None] * len(audios)

    def client(i):
        replies[i] = stream_client("127.0.0.1", server.port, audios[i],
                                   block=1600)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(audios))]
    counters = launch_counters()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a connection did not finish")
    return replies, [c.value for c in counters], wall


def concurrent_eager(seed, model, audios, steps):
    """The same connections through `cli serve` without --slots: each
    connection's own eager chunk steps (the yardstick of the slot pool's
    aggregate rate). Checked: eof, a line a chunk step, the launches."""
    from fnssl_tpu_torch.cli.main import build_parser, build_server

    with tempfile.TemporaryDirectory() as log_dir:
        server, _ = quiet(build_server, build_parser().parse_args(
            ["serve", "--model", model, "--port", "0", "--seed", str(seed),
             "--log-dir", log_dir]))
    locs = []
    make_session = server.session_factory

    def tracked():
        loc, decode = make_session()
        locs.append(loc)
        return loc, decode

    server.session_factory = tracked
    server.start()
    try:
        replies, launched, wall = concurrent_connections(server, audios)
    finally:
        server.shutdown()
    n = len(audios) * steps
    if launched != [k * n for k in CHUNK_LAUNCHES[model]] or any(
            r[-1] != {"eof": True, "outputs": steps} for r in replies):
        raise AssertionError(f"eager {model}: launches {launched}")
    rtf = [loc.rtf for loc in locs]
    log(f"  the same {len(audios)} connections without --slots (eager chunk "
        f"steps a connection): {wall:.2f} s = {n / wall:.1f} chunk steps/s; "
        f"RTF per connection min {min(rtf):.4f} max {max(rtf):.4f}")
    return {"wall_s": wall, "chunk_steps_per_s": n / wall,
            "rtf_per_connection": rtf, "launches": launched}


def phase_slots_once(seed, device, model):
    """`cli serve --model model --slots 16` on the card: the pool captures
    tiers 1, 4 and 16 as CUDA graphs before traffic; 16 concurrent TCP
    connections of SLOT_AUDIO_S of audio (15 chunk steps each, 30 for
    IPDnet2).
    Checked: eof and a line a chunk step on each; each connection's
    outputs within 1e-3 of a dedicated stream of the same audio on the
    card (its own eager chunk steps at batch 1; another cluster plan) and
    its DOAs equal but at exact ties; the live run traced: no wrapper
    launched a kernel (every tick a graph replay) and the trace's K1/K3
    kernels equal each tier's traced replay times its replays; each
    tier's replay equal to the tier run eagerly, with the kernels of one
    chunk step in both. Measured: capture seconds, the ms a tick per tier,
    the ticks and mean occupancy of the live run, the aggregate chunk
    steps a second, each connection's RTF; for EAGER_BASELINE, the same
    connections without --slots."""
    from fnssl_tpu_torch.cli.main import build_parser, build_server

    nch = SERVE_NCH.get(model, 2)
    with tempfile.TemporaryDirectory() as log_dir:
        t0 = time.perf_counter()
        server, info = quiet(build_server, build_parser().parse_args(
            ["serve", "--model", model, "--slots", str(SLOTS), "--port",
             "0", "--seed", str(seed), "--log-dir", log_dir]))
        warm_s = time.perf_counter() - t0
    pool, st = server.pool, server.pool.stepper
    if info["model_device"] != str(device) or st.tier_sizes[-1] != SLOTS:
        raise AssertionError(f"slots pool: {info}, tiers {st.tier_sizes}")
    sessions = []
    make_session = server.session_factory

    def recorded_session():
        loc, decode = make_session()
        step, rec = loc.model_step, []

        def wrapped(feats):
            t0 = time.perf_counter()
            out = step(feats)
            loc.wait_s += time.perf_counter() - t0
            rec.append(out)
            return out

        wrapped.close = step.close
        loc.model_step, loc.wait_s = wrapped, 0.0
        sessions.append((loc, rec))
        return loc, decode

    server.session_factory = recorded_session
    server.start()
    conns = [(seed + 500 + k, (-5, -3, 0, 3, 5)[k % 5]) for k in range(SLOTS)]
    audios = [make_audio(s, d, nch, SLOT_AUDIO_S) for s, d in conns]
    try:
        replays0, ticks0, occ0 = dict(st.replays), pool.ticks, pool.occupancy
        (replies, wrapped, wall), launched = traced_launches(
            concurrent_connections, server, audios)
        replays = {s: st.replays[s] - replays0[s] for s in st.tier_sizes}
        ticks, occupancy = pool.ticks - ticks0, pool.occupancy - occ0
    finally:
        server.shutdown()
    if any(wrapped) or sum(replays.values()) != ticks or not ticks:
        raise AssertionError(f"slots {model}: wrapper launches {wrapped} "
                             f"(replays {replays}, ticks {ticks})")
    steps = chunk_steps(model, int(SLOT_AUDIO_S * FS))
    errs, ties, unmatched = [], 0, list(range(len(sessions)))
    if len(sessions) != SLOTS:
        raise AssertionError(f"slots {model}: {len(sessions)} sessions")
    for (s, d), msgs, audio in zip(conns, replies, audios):
        if msgs[-1] != {"eof": True, "outputs": steps} \
                or len(msgs) != steps + 1:
            raise AssertionError(f"slots {model} connection {s}: "
                                 f"{len(msgs) - 1} lines, {msgs[-1]}")
        outs, doas, ss = reference_stream(seed, audio, 1600, model, device)
        # the server's session of this connection: the one whose outputs
        # are nearest its dedicated stream's
        dist = {i: max((g.cpu() - w).abs().max().item() for g, w in zip(
            sessions[i][1], outs)) for i in unmatched
            if len(sessions[i][1]) == steps}
        if not dist:
            raise AssertionError(f"slots {model} connection {s}: no session")
        best = min(dist, key=dist.get)
        unmatched.remove(best)
        errs.append(dist[best])
        if not errs[-1] <= 1e-3:
            raise AssertionError(f"slots {model} connection {s}: max|diff| "
                                 f"{errs[-1]} vs its dedicated stream")
        ties += held_lines(f"slots {model} connection {s}", msgs[:-1], doas,
                           ss)
    rows = pool.rows
    tiers, per_tick = tier_checks(st, rows, pool._feats_shape[1:], device,
                                  functools.partial(tick_launches, model))
    want = [sum(per_tick[s][i] * replays[s] for s in st.tier_sizes)
            for i in range(len(COUNTED))]
    if launched != want:
        raise TraceShort(f"slots {model}: traced launches {launched}, "
                         f"expected {want} (replays {replays})")
    rtf = [loc.rtf for loc, _ in sessions]
    # where a connection's push time went, a chunk step: waiting for its
    # tick (submit to result), and the rest (framing, STFT, norm)
    wait_ms = np.mean([loc.wait_s for loc, _ in sessions]) / steps * 1e3
    front_ms = np.mean([loc.compute_s - loc.wait_s
                        for loc, _ in sessions]) / steps * 1e3
    # the dispatcher's share of the wall in ticks, from each tier's ms a
    # tick (tier_checks) times its replays in the run
    busy = sum(replays[s] * tiers[s]["ms_mean"] for s in replays) / 1e3 / wall
    report = {"capture_s": warm_s, "tiers": tiers, "ticks": ticks,
              "wait_ms_per_chunk_step": wait_ms,
              "front_end_ms_per_chunk_step": front_ms,
              "dispatcher_busy_share": busy,
              "replays": replays, "mean_occupancy": occupancy / ticks,
              "chunk_steps": SLOTS * steps, "wall_s": wall,
              "chunk_steps_per_s": SLOTS * steps / wall,
              "launches_per_tick": {s: dict(zip(COUNTED, per_tick[s]))
                                    for s in st.tier_sizes},
              "rtf_per_connection": rtf,
              "max_abs_err_vs_dedicated": max(errs), "ties": ties}
    log(f"  slots {model}: {SLOTS} connections x {steps} chunk steps in "
        f"{wall:.2f} s = {SLOTS * steps / wall:.1f} chunk steps/s; {ticks} "
        f"ticks, mean occupancy {occupancy / ticks:.2f}, replays {replays}; "
        f"outputs vs dedicated streams max|diff| {max(errs):.3e}, DOAs equal "
        f"(ties {ties}); capture of the 3 tiers {warm_s:.2f} s")
    log("  ms a tick (all slots of the tier active; features up, replay, "
        "outputs down): " + ", ".join(
            f"tier {s} {v['ms_mean']:.3f} (p90 {v['ms_p90']:.3f})"
            for s, v in tiers.items())
        + f"; launches a tick {[per_tick[s] for s in st.tier_sizes]}")
    log(f"  RTF per connection: min {min(rtf):.4f} max {max(rtf):.4f}; a "
        f"connection's chunk step: {wait_ms:.2f} ms waiting for its tick, "
        f"{front_ms:.2f} ms in its front end; the dispatcher in ticks "
        f"{busy:.1%} of the wall (tier ms x replays)")
    if model in EAGER_BASELINE:
        report["eager"] = concurrent_eager(seed, model, audios, steps)
    return report, dict(zip(COUNTED, launched))


class TraceShort(AssertionError):
    """A live run's trace counted other kernels than its replays ran."""


def phase_slots(seed, device, model):
    """phase_slots_once, taken once more, on a new server and under a new
    trace, if only its trace's kernel count failed: a trace can lose every
    record of one graph replay (seen on the H100 in IPDnet2's live run of
    ~130 replays, twice, while every output matched its dedicated stream
    and no wrapper launched). The run kept must count exactly."""
    try:
        return phase_slots_once(seed, device, model)
    except TraceShort as e:
        log(f"  ({e}: the 16 connections again, under a new trace)")
        return phase_slots_once(seed, device, model)


def phase_export(seed, device, tmp):
    """`cli export --platforms cuda` of forward and stream artifacts
    (fnssl, ipdnet, ipdnet2) and a forward artifact (variable_ipdnet),
    fresh weights from `seed`; each loaded without model code and held
    against its direct module on the card (forward 1e-5; a stream artifact
    run chunk by chunk against the one-shot forward, 1e-4: another batch,
    another cluster plan), the same launches as the module; CPU_TOO's CPU
    program against the card's; then one `serve --artifact` TCP
    connection against a dedicated stream."""
    from fnssl_tpu_torch.cli.main import (_task_for, build_parser,
                                          build_server, load_model)
    from fnssl_tpu_torch.runtime.export import load_artifact
    from fnssl_tpu_torch.runtime.server import stream_client

    counters = launch_counters()

    def counted_call(fn, *args):
        for c in counters:
            c.reset()
        with torch.no_grad():
            out = fn(*args)
        torch.cuda.synchronize()
        return out, [c.value for c in counters]

    report, totals = {}, [0] * len(COUNTED)
    gen = torch.Generator().manual_seed(seed)
    for model, modes in EXPORTS:
        task = _task_for(model, device)
        module = quiet(load_model, model, str(tmp / "none"), seed, device,
                       cfg=task.cfg)
        for mode in modes:
            out = tmp / f"art_{model}_{mode}"
            platforms = EXPORT_PLATFORM + (",cpu" if (model, mode) == CPU_TOO
                                           else "")
            res, _, secs = cli(["export", "--model", model, "--mode", mode,
                                "--platforms", platforms, "--out", str(out),
                                "--seed", str(seed), "--log-dir",
                                str(tmp / "none")])
            art = load_artifact(str(out), device)
            shape = res["input_shape"]
            chunks = 2 if mode == "stream" else 1
            feats = torch.randn(shape[:-1] + [shape[-1] * chunks],
                                generator=gen)
            want, want_n = counted_call(module, feats.to(device))
            if mode == "forward":
                got, got_n = counted_call(art, feats)
                tol = 1e-5
            else:
                parts = [counted_call(art, feats[..., k * shape[-1]:
                                                 (k + 1) * shape[-1]])
                         for k in range(chunks)]
                got = torch.cat([p[0] for p in parts], dim=1)
                got_n = [sum(n) for n in zip(*(p[1] for p in parts))]
                want_n = [chunks * n for n in FORWARD_LAUNCHES[model]]
                tol = 1e-4
            err = (got - want).abs().max().item()
            if not (err <= tol and got_n == want_n and any(got_n)):
                raise AssertionError(f"export {model} {mode}: max|diff| {err}"
                                     f" (tol {tol}), launches {got_n} vs "
                                     f"{want_n}")
            totals = [a + b for a, b in zip(totals, got_n)]
            if (model, mode) == CPU_TOO:
                # the same artifact's CPU program, chunk by chunk, against
                # the card's (the CPU-vs-card tolerance of the serve paths)
                on_cpu = load_artifact(str(out), "cpu")
                cpu_out = torch.cat([on_cpu(feats[..., k * shape[-1]:
                                                  (k + 1) * shape[-1]])
                                     for k in range(chunks)], dim=1)
                cpu_err = (cpu_out - got.cpu()).abs().max().item()
                if not (cpu_err <= 1e-3 and res["platforms"] == [
                        "cuda", "cpu"]):
                    raise AssertionError(f"export {model} {mode}: the cpu "
                                         f"program max|diff| {cpu_err}")
                log(f"  export {model} {mode} for {res['platforms']}: the cpu"
                    f" program within {cpu_err:.3e} of the card's")
            x = feats[..., :shape[-1]]
            ms = {"artifact_ms": host_ms(art.clone() if mode == "stream"
                                         else art, x),
                  "module_ms": host_ms(module, x.to(device))}
            report[f"{model}_{mode}"] = {"export_s": secs,
                                         "max_abs_err": err,
                                         "launches": got_n, **ms}
            log(f"  export {model} {mode}: {secs:.2f} s; artifact vs "
                f"{'module' if mode == 'forward' else 'one-shot module'} "
                f"max|diff| {err:.3e}; launches {got_n}; a call "
                f"{ms['artifact_ms']:.3f} ms (module {ms['module_ms']:.3f} "
                f"ms) at {shape}")
    server, info = quiet(build_server, build_parser().parse_args(
        ["serve", "--artifact", str(tmp / "art_fnssl_stream"), "--port",
         "0"]))
    server.start()
    audio = make_audio(seed + 600, 3)
    try:
        for c in counters:
            c.reset()
        msgs = stream_client("127.0.0.1", server.port, audio, block=1600)
        launched = [c.value for c in counters]
    finally:
        server.shutdown()
    steps = chunk_steps("fnssl")
    if msgs[-1] != {"eof": True, "outputs": steps} or launched != [
            n * steps for n in FORWARD_LAUNCHES["fnssl"]]:
        raise AssertionError(f"serve --artifact: {msgs[-1]}, launches "
                             f"{launched}")
    _, doas, ss = reference_stream(seed, audio, 1600, "fnssl", device)
    ties = held_lines("serve --artifact", msgs[:-1], doas, ss)
    totals = [a + b for a, b in zip(totals, launched)]
    report["serve_artifact"] = {"chunk_steps": steps, "ties": ties,
                                "launches": launched}
    log(f"  serve --artifact ({info['serving']}): {steps} lines and eof, "
        f"DOAs equal to a dedicated stream (ties {ties}); launches "
        f"{launched}")
    return report, dict(zip(COUNTED, totals))


# --------------------------------------------------------------------------
# The last slice (phases 26-28): `cli locata` (FN-SSL on LOCATA, K1),
# IPDnet2's MHSA and retention time modules, and `fit --profile` /
# `--debug-nans`

# phase 26: a synthetic LOCATA tree in the reference layout, (task,
# recording) pairs of LOCATA_S s of 15-channel 48 kHz audio (dicit; as
# short as the script's time limit asks: the CPU run scales with it)
# 2 recordings, one of each task: `cli locata --platform cpu` runs them on
# the host's time
LOCATA_TASKS, LOCATA_RECORDINGS, LOCATA_S = (3, 5), (1,), 12.0
LOCATA_FS, LOCATA_SILENCE, LOCATA_BURST = 48000, 4800, 2400
LOCATA_LAUNCHES = [LAUNCHES_PER_CHUNK, 0, 0, 0, 0, 0, 0, 0]  # a recording
LOCATA_MICS = (8, 5)                  # `cli locata`'s default --mic-pick
# phase 27: the time modules, each at SpatialNetConfig()'s width
TIME_CONFIGS = (("mhsa(251)", False), ("mhsa(251)", "ALiBi"),
                ("ret(2)", False), ("ret(2)", True))
STREAM_TOL = {"mhsa": 2e-4, "ret": 2e-2}  # tests/test_spatialnet_attention
TIME_STREAM_NT, TIME_CHUNK = 40, 5
# retention alone at layer 0's shape in a train step: nb 16 x 16 bins left
# after the frequency pools = 256 sequences of 201 frames (4 s), H 96
RET_SHAPE = (256, 201, 96, 4)


def _write_tsv(path, cols):
    keys = list(cols)
    rows = zip(*(cols[k] for k in keys))
    path.write_text("\t".join(keys) + "\n" + "".join(
        "\t".join(str(v) for v in row) + "\n" for row in rows))


def write_locata(root, seed):
    """A LOCATA tree under `root` (the form tests/test_locata.py writes):
    per (task, recording) a static DICIT array at the origin (identity
    rotation), one static talker 2 m away at its own azimuth whose noise
    reaches each mic with its far-field delay, LOCATA_SILENCE samples of
    leading silence and then a 1 kHz burst, the same on every mic and
    recording (so that the silence strip, and the frame count, is the same
    for all), and a VAD of alternating 2 s blocks."""
    from fnssl_tpu_torch.data.arrays import dicit_array_setup
    from fnssl_tpu_torch.utils.audio_io import write_audio

    rng = np.random.default_rng(seed)
    n, fs = int(LOCATA_S * LOCATA_FS), LOCATA_FS
    mics = dicit_array_setup().mic_pos
    npts = 21
    ts = np.linspace(0, LOCATA_S, npts)
    burst = 0.9 * np.sin(2 * np.pi * 1000 * np.arange(LOCATA_BURST) / fs)
    vad = (np.arange(n) // (2 * fs)) % 2 == 0
    pose = {"hour": [10] * npts, "minute": [0] * npts, "second": list(ts)}
    for k, (task, rec) in enumerate(
            (t, r) for t in LOCATA_TASKS for r in LOCATA_RECORDINGS):
        d = root / f"task{task}" / f"recording{rec}" / "dicit"
        d.mkdir(parents=True)
        azi = np.radians(30.0 + 40.0 * k)
        u = np.array([np.cos(azi), np.sin(azi), 0.0])
        proj = mics @ u
        delays = np.round((proj.max() - proj) / 343.0 * fs).astype(int)
        src = rng.standard_normal(n + delays.max()).astype(np.float32) * 0.1
        sig = np.stack([src[delays.max() - a: delays.max() - a + n]
                        for a in delays], axis=1)
        sig += rng.standard_normal(sig.shape).astype(np.float32) * 0.005
        sig[:LOCATA_SILENCE] = 0.0
        sig[LOCATA_SILENCE: LOCATA_SILENCE + LOCATA_BURST] = burst[:, None]
        write_audio(str(d / "audio_array_dicit.wav"), sig, fs)
        write_audio(str(d / "audio_source_talker1.wav"), src[:n], fs)
        array = dict(pose, x=[0.0] * npts, y=[0.0] * npts, z=[0.0] * npts)
        for i in range(3):
            for j in range(3):
                array[f"rotation_{i + 1}{j + 1}"] = [float(i == j)] * npts
        _write_tsv(d / "position_array_dicit.txt", array)
        _write_tsv(d / "required_time.txt", pose)
        _write_tsv(d / "position_source_talker1.txt",
                   {c: [2 * v] * npts for c, v in zip("xyz", u)})
        _write_tsv(d / "VAD_dicit_talker1.txt", {"VAD": vad.astype(int)})


def locata_frames(root):
    """The STFT frame count FN-SSL sees for each recording of the tree (hop
    256, window 512, center=False) after the reader's decimation and
    silence strip; they must all be equal."""
    from fnssl_tpu_torch.data import LocataDataset

    ds = LocataDataset(str(root), tasks=LOCATA_TASKS,
                       return_acoustic_scene=True)
    frames = {1 + (len(ds[i][0]) - 512) // 256 for i in range(len(ds))}
    if len(frames) != 1:
        raise AssertionError(f"the LOCATA recordings give {frames} frames")
    return frames.pop()


def locata_shapes(frames):
    """K1's shapes in `cli locata --model fnssl` (B = 1 recording): the
    full-band BiLSTMs over 256 bins for every frame, the narrow-band LSTMs
    over the frames for every bin."""
    return [("locata_fullband", 256, frames, 128, 256, 2),
            ("locata_narrowband", frames, 256, 256, 256, 1)]


def locata_cli(argv, want, what):
    """counted_cli(argv, want, what) and FN-SSL's raw output of each
    recording as the command computed it (on the host, in the order of
    the recordings)."""
    from fnssl_tpu_torch.models.fnssl import FNSSL

    outs = []

    def keep(module, args, out):
        if isinstance(module, FNSSL):
            outs.append(out.detach().float().cpu())

    hook = torch.nn.modules.module.register_module_forward_hook(keep)
    try:
        return (*counted_cli(argv, want, what), outs)
    finally:
        hook.remove()


def locata_spectra(pred):
    """(1 track, frames, grid): the spatial spectrum `cli locata` decodes
    `pred` on (the picked pair's grid), for `same_or_tie`."""
    from fnssl_tpu_torch.data.arrays import dicit_array_setup
    from fnssl_tpu_torch.eval.pred_doa import PredDOA

    pos = dicit_array_setup().mic_pos
    res = PredDOA(mic_location=tuple(pos[m] for m in LOCATA_MICS),
                  device="cpu").predgt2doa(pred)[0]
    return res["spatial_spectrum"].reshape(1, pred.shape[1], -1).numpy()


def phase_locata(seed, device, root, runs, frames, card):
    """`cli locata` on the synthetic tree: FN-SSL from phase 10's
    best_model.tar on the card (6 K1 launches a recording, no other
    kernel), the same command on the CPU (same metrics, every
    recording's raw output within 1e-3 and est within 1e-3 degrees but at
    exact decode ties), the model-free baseline, the npy
    dumps and the plot (or, where matplotlib is not installed, `--plot`'s
    refusal); then K1 at the locata shapes (as phase 5)."""
    import importlib.util
    import shutil

    from fnssl_tpu_torch.models.fnssl import FNSSL
    from fnssl_tpu_torch.train.convert import save_torch_tar

    log_dir = runs / "locata_fnssl"
    log_dir.mkdir(parents=True)
    best = runs / "fnssl" / "best_model.tar"
    if best.exists():
        shutil.copy(best, log_dir / "best_model.tar")
        weights = "phase 10's best_model.tar"
    else:
        save_torch_tar(str(log_dir / "best_model.tar"), FNSSL(
            device="cpu", generator=torch.Generator().manual_seed(seed))
            .state_dict())
        weights = f"fresh weights from --seed {seed}"
    n = len(LOCATA_TASKS) * len(LOCATA_RECORDINGS)
    common = ["locata", "--locata-dir", str(root), "--tasks",
              ",".join(map(str, LOCATA_TASKS)), "--log-dir", str(log_dir),
              "--seed", str(seed)]
    plot = importlib.util.find_spec("matplotlib") is not None
    out = {k: runs / f"locata_{k}" for k in ("card", "cpu", "baseline")}
    res, _, launched, secs, card_preds = locata_cli(
        common + ["--model", "fnssl", "--out", str(out["card"])]
        + (["--plot"] if plot else []),
        [k * n for k in LOCATA_LAUNCHES], f"locata fnssl ({weights})")
    if not (res["recordings"] == n and np.isfinite(res["MAE"])
            and np.isfinite(res["ACC"])):
        raise AssertionError(f"locata fnssl: {res}")
    dumps = [out["card"] / f"{i}_{f}.npy" for i in range(n)
             for f in ("gt", "est", "vadgt")]
    missing = [str(f) for f in dumps if not f.exists()]
    if missing:
        raise AssertionError(f"locata fnssl: no {missing}")
    if plot:
        if not (out["card"] / "locata_fig.jpg").stat().st_size:
            raise AssertionError("locata --plot wrote no figure")
        plotted = "written"
    else:
        try:
            cli(common + ["--model", "fnssl", "--out", str(runs / "x"),
                          "--plot"])
        except SystemExit as e:
            if "needs matplotlib" not in str(e):
                raise
        else:
            raise AssertionError("locata --plot ran without matplotlib")
        plotted = "refused: matplotlib is not installed on this machine"
    cpu, _, _, cpu_secs, cpu_preds = locata_cli(
        common + ["--model", "fnssl", "--platform", "cpu", "--out",
                  str(out["cpu"])], [0] * len(COUNTED),
        "locata fnssl --platform cpu")
    # the decoded DOAs are grid points (and a briefly trained model may
    # decode every frame alike): hold every recording's raw output too,
    # the card's run against the CPU's (1e-3, as phase 22)
    if not len(card_preds) == len(cpu_preds) == n:
        raise AssertionError(f"locata fnssl ran the model {len(card_preds)}"
                             f" times on the card and {len(cpu_preds)} on "
                             f"the CPU for {n} recordings")
    ties, est, out_err = 0, [], 0.0
    for i, (card_pred, cpu_pred) in enumerate(zip(card_preds, cpu_preds)):
        err = (card_pred - cpu_pred).abs().max().item()
        if not err <= 1e-3:
            raise AssertionError(f"locata recording {i}: output max|diff| "
                                 f"{err} vs the CPU > 1e-3")
        out_err = max(out_err, err)
        got = np.load(out["card"] / f"{i}_est.npy")[0]
        want = np.load(out["cpu"] / f"{i}_est.npy")[0]
        est.append(got[:, 1])
        if not np.allclose(got, want, rtol=0, atol=1e-3):
            ties += same_or_tie(f"locata recording {i}", got, want,
                                locata_spectra(cpu_pred))
    azimuths = np.unique(np.round(np.concatenate(est), 3)).tolist()
    metric_diff = max(abs(res[k] - cpu[k]) for k in cpu)
    if sorted(res) != sorted(cpu) or (ties == 0 and metric_diff > 1e-6):
        raise AssertionError(f"locata fnssl: card {res}, CPU {cpu}")
    base, _, _, base_secs = counted_cli(
        ["locata", "--model", "ipd_baseline", "--locata-dir", str(root),
         "--tasks", ",".join(map(str, LOCATA_TASKS)), "--out",
         str(out["baseline"])], [0] * len(COUNTED), "locata ipd_baseline")
    if not (base["recordings"] == n and np.isfinite(base["MAE"])):
        raise AssertionError(f"locata ipd_baseline: {base}")
    log(f"  locata fnssl on the card: {n} recordings of {LOCATA_S} s "
        f"({frames} frames each), {secs:.2f} s (reads included), "
        f"launches {launched}; on the CPU {cpu_secs:.2f} s; the {n} "
        f"recordings' output max|diff| vs the CPU {out_err:.2e}; est equal but at {ties}"
        f" exact ties, azimuths taken {azimuths[:8]}"
        f"{' ...' if len(azimuths) > 8 else ''}; metrics card {res}, CPU "
        f"{cpu}; plot "
        f"{plotted}; ipd_baseline {base} in {base_secs:.2f} s; {card}")
    log("  K1 at the locata shapes (one recording: 3 launches of each)")
    rows = phase_times(device, locata_shapes(frames))
    return ({"frames": frames, "weights": weights, "card": res, "cpu": cpu,
             "output_max_abs_err": out_err, "ties": ties,
             "azimuths": azimuths, "seconds": secs, "cpu_seconds": cpu_secs,
             "baseline": base, "plot": plotted, "k1_rows": rows},
            dict(zip(COUNTED, launched)))


def time_setup(attention, rope, seed, nb, device):
    """ipdnet2_setup with the time modules of (attention, rope) in
    SpatialNetConfig()."""
    from fnssl_tpu_torch.models.spatialnet import SpatialNetConfig

    return ipdnet2_setup(seed, nb, device,
                         cfg=SpatialNetConfig(attention=attention, rope=rope))


def phase_time_modules(seed, device, mamba_step_ms, card):
    """IPDnet2 with each of TIME_CONFIGS' time modules at full width: the
    forward at bench.py:460-481's cell (nb 16, nt 200) on the card against
    the CPU (1e-3) and timed (5 warm runs, peak memory); streaming on the
    card (5-frame chunks over 40 frames) against its one-shot forward at
    JAX's tolerances; one fp32 train step on the card against the CPU
    (nb 2, phase 19's tolerances and gates); the train cell of
    bench.py:138-176 (nb 16 x 4 s, 1 warm + 5 timed steps, peak memory)
    beside phase 20's Mamba step; no launch of any kernel; then
    retention's chunkwise mode against its parallel mode at layer 0's
    shape."""
    from fnssl_tpu_torch.models.retention import (
        Retention, RetentionConfig, RetNetRelPos, retention_chunkwise,
        retention_parallel)
    from fnssl_tpu_torch.models.spatialnet import (
        SpatialNet, SpatialNetConfig, init_spatialnet_state)

    report = {}
    counts = launch_counters()
    for c in counts:
        c.reset()
    for attention, rope in TIME_CONFIGS:
        name = f"{attention} rope={rope}"
        cfg = SpatialNetConfig(attention=attention, rope=rope)
        row = {}
        host = SpatialNet(cfg, device="cpu", generator=torch.Generator()
                          .manual_seed(seed)).eval()
        net = SpatialNet(cfg, device=device).eval()
        net.load_state_dict(host.state_dict())
        x = torch.randn(I2_NB, 10, 256, I2_FWD_NT,
                        generator=torch.Generator().manual_seed(seed))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            xd = x.to(device)
            got = net(xd).cpu()
            want = host(x)
            row["forward_max_abs_err"] = (got - want).abs().max().item()
            ms = []
            for _ in range(1 + 5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net(xd)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            ms = np.array(ms[1:])
            row.update(forward_ms_mean=float(ms.mean()),
                       forward_ms_p90=float(np.percentile(ms, 90)),
                       forward_peak_bytes=torch.cuda.max_memory_allocated())
            xs = xd[:2, ..., :TIME_STREAM_NT]
            oneshot = net(xs)
            state = init_spatialnet_state(2, cfg, device)
            outs = []
            for lo in range(0, TIME_STREAM_NT, TIME_CHUNK):
                o, state = net(xs[..., lo:lo + TIME_CHUNK], state=state,
                               return_state=True)
                outs.append(o)
            row["stream_max_abs_err"] = (torch.cat(outs, 1) - oneshot
                                         ).abs().max().item()
        del host, net, x, xd
        if not row["forward_max_abs_err"] <= 1e-3:
            raise AssertionError(f"{name}: forward max|diff| vs the CPU "
                                 f"{row['forward_max_abs_err']} > 1e-3")
        tol = STREAM_TOL[cfg.time_kind]
        if not row["stream_max_abs_err"] <= tol:
            raise AssertionError(f"{name}: streamed max|diff| vs one-shot "
                                 f"{row['stream_max_abs_err']} > {tol}")
        log(f"  {name}: forward nb={I2_NB} nt={I2_FWD_NT} max|diff| vs CPU "
            f"{row['forward_max_abs_err']:.2e}, {row['forward_ms_mean']:.2f}"
            f" ms mean, p90 {row['forward_ms_p90']:.2f}, peak "
            f"{row['forward_peak_bytes'] / 2**30:.2f} GiB; streamed "
            f"{TIME_CHUNK}-frame chunks vs one-shot max|diff| "
            f"{row['stream_max_abs_err']:.2e} (tol {tol}); {card}")
        row["parity"] = phase_train_parity(
            seed, device, functools.partial(time_setup, attention, rope,
                                            seed, I2_PARITY_NB),
            lr=I2_LR, want=[0] * len(COUNTED), gates=I2_GATES)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, step, batch = time_setup(attention, rope, seed, I2_NB,
                                        device)
        state, ms, losses = timed_steps(state, step, batch, None,
                                        TIMED_STEPS)
        if not np.isfinite(losses).all():
            raise AssertionError(f"{name}: losses {losses}")
        row.update(step_ms_mean=float(ms.mean()),
                   step_ms_p90=float(np.percentile(ms, 90)),
                   step_ms=ms.tolist(),
                   step_peak_bytes=torch.cuda.max_memory_allocated(),
                   losses=losses)
        del state, step, batch
        log(f"  {name}: train nb={I2_NB} x {I2_T_S} s fp32 "
            f"{row['step_ms_mean']:.2f} ms a step (p90 "
            f"{row['step_ms_p90']:.2f}), peak "
            f"{row['step_peak_bytes'] / 2**30:.2f} GiB; phase 20's Mamba "
            f"step {mamba_step_ms:.2f} ms; {card}")
        report[name] = row
    launched = [c.value for c in counts]
    if launched != [0] * len(COUNTED):
        raise AssertionError(f"the time modules launched {COUNTED} "
                             f"{launched}, expected none")
    log(f"  launches {COUNTED} {launched}: MHSA and retention launch no "
        "kernel of the port")
    torch.cuda.empty_cache()
    b, t, h, heads = RET_SHAPE
    ret = Retention(RetentionConfig(h, heads), device=device,
                    generator=torch.Generator().manual_seed(seed))
    x = torch.randn(b, t, h, device=device)
    pos = RetNetRelPos(h, heads, 20)
    chunk_tab = pos(t, chunkwise_recurrent=True, device=device)
    par_tab = pos(t, device=device)
    with torch.no_grad():
        report["retention_alone"] = {
            "shape": {"B": b, "T": t, "H": h, "heads": heads},
            "chunkwise_ms": cuda_ms(
                lambda: retention_chunkwise(ret, x, chunk_tab), 20),
            "parallel_ms": cuda_ms(
                lambda: retention_parallel(ret, x, par_tab), 20)}
    r = report["retention_alone"]
    log(f"  retention alone at layer 0's shape (B={b}, T={t}, H={h}, "
        f"{heads} heads, chunks of 20): chunkwise {r['chunkwise_ms']:.3f} "
        f"ms, parallel {r['parallel_ms']:.3f} ms (CUDA events); {card}")
    return report, dict(zip(COUNTED, launched))


def phase_fit_flags(seed, device, data, runs, card):
    """`fit --model fnssl` on phase 10's corpus at full width, 1 epoch
    (FIT_TRAIN scenes): plain, with `--profile 1` (the trace
    exists and names K1's and K2's kernels) and with `--debug-nans`
    (finite losses; its ms a step beside the plain fit's); exact
    launches."""
    steps, valid = FIT_TRAIN // FIT_BZ, -(-FIT_DEV // FIT_BZ)
    want = fnssl_path_launches(steps, valid)
    report, total = {}, [0] * len(COUNTED)
    for name, flags in (("plain", []), ("profile", ["--profile", "1"]),
                        ("debug_nans", ["--debug-nans"])):
        log_dir = runs / f"flags_{name}"
        res, _, launched, secs = counted_cli(
            ["fit", "--model", "fnssl", "--train-dir", str(data / "train"),
             "--valid-dir", str(data / "dev"), "--bz", str(FIT_BZ),
             "--epochs", "1", "--train-size", str(FIT_TRAIN), "--seed",
             str(seed), "--log-dir", str(log_dir), *flags], want,
            f"fit fnssl {' '.join(flags) or '(plain)'}")
        total = [a + b for a, b in zip(total, launched)]
        if not (np.isfinite(res["final_train"])
                and np.isfinite(res["final_valid"])):
            raise AssertionError(f"fit {flags}: losses {res}")
        st = epoch_stats(log_dir)[0]
        report[name] = {"fit": res, "seconds": secs, "epoch": st}
        if name == "profile":
            path = log_dir / "profile" / "trace.json"
            names = {e.get("name", "") for e in
                     json.loads(path.read_text())["traceEvents"]}
            hits = [traced_index(n) for n in names]
            found = {k: hits.count(i) for i, k in enumerate(TRACED)
                     if k != "selective_fwd_kernel"
                     and k != "selective_bwd_kernel"}
            # every K1 and K2 kernel a train step launches
            launched = [TRACED[i] for i, n in enumerate(
                step_launches(FIT_BZ)) if n]
            if not all(found[k] for k in launched):
                raise AssertionError(f"the fit's trace names {found} of the "
                                     f"step's K1 and K2 kernels {launched}")
            report[name]["trace_bytes"] = path.stat().st_size
            log(f"  the trace {path.name}: {path.stat().st_size / 2**20:.1f}"
                f" MiB, {len(names)} event names; K1/K2 kernel names "
                f"{found}")
    plain = report["plain"]["epoch"]["steady_ms_per_step"]
    for name in ("profile", "debug_nans"):
        ms = report[name]["epoch"]["steady_ms_per_step"]
        report[name]["slowdown"] = ms / plain
    log(f"  a train step after the epoch's first batch ({steps} steps of bz "
        f"{FIT_BZ}): plain {plain:.1f} ms, --profile "
        f"{report['profile']['epoch']['steady_ms_per_step']:.1f} ms "
        f"(x{report['profile']['slowdown']:.2f}), --debug-nans "
        f"{report['debug_nans']['epoch']['steady_ms_per_step']:.1f} ms "
        f"(x{report['debug_nans']['slowdown']:.2f}); {card}")
    return report, dict(zip(COUNTED, total))


# phase 29, data parallelism: the global batch of the two-rank cells, the
# DP steps each takes, and the trace names of NCCL's all-reduce
DP_NB, DP_STEPS = 16, 3
# the recurrences (as TRAIN_SHAPES) and scans (as SSM_SHAPES) of one rank's
# step on DP_NB / 2 scenes, which phases 6 and 17 hold against the plain
# versions
DP_RANK_SHAPES = [("dp_rank_fullband", 256, DP_NB // 2 * 298, 128, 256, 2),
                  ("dp_rank_narrowband", 298, DP_NB // 2 * 256, 256, 256, 1)]
SSM_DP_SHAPES = [("dp_rank_layer0", DP_NB // 2 * 16, 201, 192),
                 ("dp_rank_layers1_7", DP_NB // 2 * 16, 40, 192)]
# phase 30, frequency parallelism: a 2 x 2 mesh of ranks on the one card;
# a rank's scans run its DP_NB / 2 scenes x 8 of the 16 bands
FP_MESH = (2, 2)
SSM_FP_SHAPES = [("fp_rank_layer0", DP_NB // 2 * 8, 201, 192),
                 ("fp_rank_layers1_7", DP_NB // 2 * 8, 40, 192)]
DP_CELLS = ("fnssl", "ipdnet2")
DP_LR = {"fnssl": 1e-3, "ipdnet2": I2_LR}


def dp_step_launches(name, nb):
    """Launches (COUNTED's order) of one train step of a DP cell on nb
    scenes."""
    return step_launches(nb) if name == "fnssl" else I2_STEP_LAUNCHES


def fit_history(log_dir):
    """(train losses, valid losses) by epoch from a fit's metrics.jsonl."""
    out = {"train/loss": {}, "valid/loss": {}}
    for line in open(Path(log_dir) / "metrics.jsonl"):
        rec = json.loads(line)
        if rec["tag"] in out:
            out[rec["tag"]][rec["step"]] = rec["value"]
    return [[d[e] for e in sorted(d)] for d in out.values()]


def dp_setup(name, seed, device):
    """(state, step, global batch) of a two-rank cell at DP_NB scenes:
    FN-SSL (phase 8's cell, Adam) or IPDnet2 (phase 20's, AdamW, clip 5),
    weights from `seed`."""
    if name == "fnssl":
        return train_setup(seed, device, DP_NB)
    return ipdnet2_setup(seed, DP_NB, device)


def dp_steps(state, step, batch):
    """DP_STEPS steps, dropout off: (state, each step's loss as the mean
    over the world's ranks, ms a step on the host clock, the first step's
    gradients on the host: averaged over the ranks by DDP and, IPDnet2's,
    clipped)."""
    from fnssl_tpu_torch.parallel import unwrap, world
    from fnssl_tpu_torch.parallel.distributed import all_reduce_sum

    size = world()[1]
    losses, ms = [], []
    for k in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(all_reduce_sum(loss[None])[0]) / size)
        if k == 0:
            grads = {n: p.grad.detach().cpu() for n, p in
                     unwrap(state.module).named_parameters()}
    return state, losses, ms, grads


def dp_rank(rank, store, out, seed):
    """One of the two ranks of phase 29 (b), in a process of its own: a
    gloo world at the file store `store` on cuda:0; each cell's DP steps
    on the rank's rows of the global batch, with every launch counter set
    to 0 just before and read just after. Writes out/rank<R>.json and,
    rank 0, each cell's parameters after the steps and its first step's
    gradients (out/<cell>.pt)."""
    from fnssl_tpu_torch.parallel import (data_parallel, initialize,
                                          shard_batch, shutdown, unwrap)

    device = initialize(f"file://{store}", 2, rank, backend="gloo",
                        timeout_s=600)
    report = {}
    for name in DP_CELLS:
        state, step, batch = dp_setup(name, seed, device)
        state = state._replace(module=data_parallel(state.module))
        local = shard_batch(batch)
        counts = launch_counters()
        for c in counts:
            c.reset()
        state, losses, ms, grads = dp_steps(state, step, local)
        report[name] = {"losses": losses, "ms": ms,
                        "launches": [c.value for c in counts],
                        "rows": len(local["mic_sig"])}
        if rank == 0:
            torch.save({"params": {k: v.cpu() for k, v in
                                   unwrap(state.module).state_dict().items()},
                        "grads": grads}, Path(out) / f"{name}.pt")
        del state, step, batch, local
        torch.cuda.empty_cache()
    shutdown()
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(report))


def nccl_events(trace_path):
    """NCCL's events in a torch.profiler trace: device kernels, and the
    host-side records of its collectives (all-reduces among them)."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    named = [e for e in events if "nccl" in str(e.get("name", "")).lower()]
    kernels = [e["name"] for e in named if e.get("cat") == "kernel"]
    host = [e["name"] for e in named if e.get("cat") != "kernel"]
    reduce_ = [n for n in kernels + host
               if re.search(r"all_?reduce", n, re.IGNORECASE)]
    return {"kernels": len(kernels), "kernel_names": sorted(set(kernels)),
            "host": len(host), "host_names": sorted(set(host)),
            "all_reduce": len(reduce_)}


def phase_dp(seed, device, data, runs, card):
    """29. Data parallelism. (a) `fit --use-mesh --profile 1` on phase
    10's corpus (FIT_TRAIN scenes, one epoch at bz FIT_BZ): a NCCL world
    of one in this process, its history against phase 28's plain fit of
    the same epoch (1e-6; phase 28 shows `--profile 1` leaves the history
    as it is), exact launches, and a trace that must hold NCCL's
    all-reduce, one at least a train step. (b) Two ranks
    on the one card (gloo: NCCL refuses two ranks on one device), each a
    process of its own, DP_STEPS DDP steps of FN-SSL and of IPDnet2 at
    full width on DP_NB / 2 scenes a rank, dropout off, against this
    process's steps on all DP_NB: world-mean losses within 1e-6 relative
    and the first step's averaged gradients within 1e-5 of their largest
    magnitude (the CPU test's bounds against one process), and the
    parameters after the steps within lr/10 (the CPU test holds them to
    lr/100 in one thread; here cuDNN's weight gradients may sum in another
    order at another batch, and Adam turns a gradient's rounding near its
    epsilon into up to lr·Δg/(4ε): sound runs read up to 2.4 lr/100),
    their distance in hundredths of lr printed, exact launches a rank.
    NCCL runs a one-rank all-reduce without a kernel, so (a) finds NCCL's
    all-reduce as the trace's host records. Prints each step's ms beside
    the plain one's."""
    steps, valid = FIT_TRAIN // FIT_BZ, -(-FIT_DEV // FIT_BZ)
    # under a mesh the eval schedule is wrap-padded to whole batches of
    # FIT_BZ scenes (cli/main.py: _eval_schedule)
    want = fnssl_path_launches(steps, valid, nb_eval=FIT_BZ)
    argv = ["fit", "--model", "fnssl", "--train-dir", str(data / "train"),
            "--valid-dir", str(data / "dev"), "--bz", str(FIT_BZ),
            "--epochs", "1", "--train-size", str(FIT_TRAIN), "--seed",
            str(seed), "--use-mesh"]
    mesh_dir = runs / "mesh"
    res, _, launched, secs = counted_cli(
        argv + ["--log-dir", str(mesh_dir), "--profile", "1"], want,
        "fit --use-mesh --profile 1 (a NCCL world of one)")
    total = list(launched)
    plain, mesh = fit_history(runs / "flags_plain"), fit_history(mesh_dir)
    diff = max(abs(a - b) / abs(a) for p, m in zip(plain, mesh)
               for a, b in zip(p, m))
    if not (len(plain[0]) == len(mesh[0]) == 1 and diff <= 1e-6):
        raise AssertionError(f"fit --use-mesh history {mesh} against the "
                             f"plain fit's {plain}")
    if torch.distributed.is_initialized():
        raise AssertionError("fit --use-mesh left its process group up")
    st = epoch_stats(mesh_dir)[0]
    plain_st = epoch_stats(runs / "flags_plain")[0]
    report = {"use_mesh": {"fit": res, "seconds": secs, "epoch": st,
                           "history_rel_diff": diff,
                           "plain_epoch": plain_st}}
    nccl = nccl_events(mesh_dir / "profile" / "trace.json")
    if nccl["all_reduce"] < steps:
        raise AssertionError(f"the --use-mesh trace holds {nccl} NCCL "
                             f"events: no all-reduce a step")
    report["use_mesh"]["trace_nccl"] = nccl
    log(f"  history of fit --use-mesh against the plain fit: max rel diff "
        f"{diff:.2e}; a step after the first batch (--profile 1 traces "
        f"the first step only) {st['steady_ms_per_step']:.1f} ms against "
        f"the plain fit's "
        f"{plain_st['steady_ms_per_step']:.1f} ms; NCCL in its trace: "
        f"{nccl['kernels']} kernels {nccl['kernel_names'][:4]}, "
        f"{nccl['host']} host records {nccl['host_names'][:4]}, "
        f"{nccl['all_reduce']} all-reduce events for {steps} steps; {card}")
    # (b) the single-process reference on the whole global batch
    ref = {}
    for name in DP_CELLS:
        torch.cuda.empty_cache()
        counts = launch_counters()
        for c in counts:
            c.reset()
        state, step, batch = dp_setup(name, seed, device)
        state, losses, ms, grads = dp_steps(state, step, batch)
        ref[name] = {"losses": losses, "ms": ms, "grads": grads,
                     "launches": [c.value for c in counts],
                     "params": {k: v.cpu() for k, v in
                                state.module.state_dict().items()}}
        del state, step, batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--seed",
               str(seed), "--dp-store", f"{tmp}/store", "--dp-out", tmp,
               "--dp-rank"]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd + [str(r)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        world_s = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, outs)):
            if p.returncode:
                raise AssertionError(f"DP rank {r} failed ({p.returncode}):"
                                     f"\n{text[-4000:]}")
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(2)]
        params = {name: torch.load(Path(tmp) / f"{name}.pt")
                  for name in DP_CELLS}
    report["two_ranks"] = {"world_s": world_s}
    for name in DP_CELLS:
        lr, one = DP_LR[name], ref[name]
        per_rank = [n * DP_STEPS for n in dp_step_launches(name,
                                                             DP_NB // 2)]
        per_one = [n * DP_STEPS for n in dp_step_launches(name, DP_NB)]
        got = [rk[name]["launches"] for rk in ranks]
        if one["launches"] != per_one or got != [per_rank, per_rank]:
            raise AssertionError(f"DP {name} launched {COUNTED} {got} a "
                                 f"rank and {one['launches']} in one "
                                 f"process, expected {per_rank} a rank and "
                                 f"{per_one} in one process")
        total = [a + b + c + d
                 for a, b, c, d in zip(total, one["launches"], *got)]
        if ranks[0][name]["losses"] != ranks[1][name]["losses"]:
            raise AssertionError(f"DP {name}: the ranks' world losses "
                                 f"differ: {ranks}")
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(ranks[0][name]["losses"], one["losses"]))
        dp = {k: (params[name]["params"][k] - v).abs().max().item()
              for k, v in one["params"].items()}
        worst = max(dp, key=dp.get)
        scale = max(g.abs().max().item() for g in one["grads"].values())
        dg = {k: (params[name]["grads"][k] - g).abs().max().item() / scale
              for k, g in one["grads"].items()}
        worst_g = max(dg, key=dg.get)
        if not (loss_rel <= 1e-6 and dg[worst_g] <= 1e-5
                and dp[worst] <= lr / 10):
            raise AssertionError(
                f"DP {name} against one process: loss rel {loss_rel:.2e}, "
                f"first step's gradients max|diff| {dg[worst_g]:.2e} of "
                f"their largest ({worst_g}), params max|diff| "
                f"{dp[worst]:.2e} ({worst}; lr {lr})")
        row = {"loss_rel": loss_rel, "grad_max_abs_diff_rel": dg[worst_g],
               "grad_worst": worst_g, "grad_scale": scale,
               "param_max_abs_diff": dp[worst],
               "param_worst": worst, "losses_dp": ranks[0][name]["losses"],
               "losses_one": one["losses"],
               "ms_rank": [rk[name]["ms"] for rk in ranks],
               "ms_one": one["ms"], "launches_a_rank": per_rank,
               "rows_a_rank": ranks[0][name]["rows"]}
        report["two_ranks"][name] = row
        dp_ms = np.mean([np.mean(m[1:]) for m in row["ms_rank"]])
        log(f"  {name}: 2 ranks x {row['rows_a_rank']} scenes (gloo, one "
            f"card) against 1 x {DP_NB}: losses rel {loss_rel:.2e}, first "
            f"step's gradients max|diff| {dg[worst_g]:.2e} of their largest "
            f"{scale:.3e} ({worst_g}), params max|diff| {dp[worst]:.2e} = "
            f"{dp[worst] / lr * 100:.2f} lr/100 ({worst}; lr {lr}); a DP step "
            f"{dp_ms:.1f} ms (steps 2-{DP_STEPS}, both ranks on the card at"
            f" once) against {np.mean(one['ms'][1:]):.1f} ms in one "
            f"process; launches {per_rank} a rank; {card}")
    log(f"  the two-rank world: {world_s:.1f} s, process start included")
    return report, dict(zip(COUNTED, total)), ref["ipdnet2"]


def fp_rank(rank, store, out, seed, backend="gloo"):
    """One of the four ranks of phase 30, in a process of its own: a
    `backend` world at the file store `store` (gloo: every rank on cuda:0;
    nccl: rank r on cuda:r), a 2 x 2 mesh, DP_STEPS
    sharded IPDnet2 steps on the rank's rows of phase 29's global batch,
    with every launch counter and the freq traffic set to 0 just before
    and read just after. Writes out/rank<R>.json and, rank 0, the
    parameters after the steps and the first step's gradients
    (out/ipdnet2.pt)."""
    from fnssl_tpu_torch.parallel import (initialize, make_mesh_2d,
                                          shard_batch, shutdown)
    from fnssl_tpu_torch.parallel.freq import TRAFFIC, reset_traffic

    device = initialize(f"file://{store}", FP_MESH[0] * FP_MESH[1], rank,
                        backend=backend, timeout_s=600)
    mesh = make_mesh_2d(*FP_MESH)
    state, step, batch = ipdnet2_setup(seed, DP_NB, device, mesh=mesh)
    local = shard_batch(batch, mesh=mesh)
    counts = launch_counters()
    for c in counts:
        c.reset()
    reset_traffic()
    state, losses, ms, grads = dp_steps(state, step, local)
    report = {"losses": losses, "ms": ms,
              "launches": [c.value for c in counts],
              "freq_bytes": TRAFFIC["bytes"], "freq_calls": TRAFFIC["calls"],
              "grad_bytes": sum(p.numel() * p.element_size()
                                for p in state.module.parameters()),
              "coords": [mesh.data_index, mesh.freq_index],
              "rows": len(local["mic_sig"])}
    if rank == 0:
        torch.save({"params": {k: v.cpu() for k, v in
                               state.module.state_dict().items()},
                    "grads": grads}, Path(out) / "ipdnet2.pt")
    shutdown()
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(report))


def fp_world_of_one(seed, device):
    """Phase 30 (a): one step of the sharded task on a 1 x 1 mesh in a
    NCCL world of one against the plain task's step, both at phase 20's
    cell from `seed`, beside a second plain step (the spread of two equal
    runs: cuDNN's weight gradients may sum in another order). Returns
    (report, launches)."""
    from fnssl_tpu_torch.parallel import initialize, make_mesh_2d, shutdown

    runs = {}
    initialize(use_mesh=True)
    try:
        for name, mesh in (("plain", None), ("again", None),
                           ("mesh", make_mesh_2d(1, 1))):
            torch.cuda.empty_cache()
            state, step, batch = ipdnet2_setup(seed, I2_NB, device,
                                               mesh=mesh)
            counts = launch_counters()
            for c in counts:
                c.reset()
            state, loss = step(state, batch)
            torch.cuda.synchronize()
            runs[name] = {"loss": float(loss),
                          "launches": [c.value for c in counts],
                          "grads": {n: p.grad.detach().clone() for n, p in
                                    state.module.named_parameters()}}
            del state, step, batch
    finally:
        shutdown()
    plain, mesh = runs["plain"], runs["mesh"]
    scale = max(g.abs().max().item() for g in plain["grads"].values())

    def rel(run):
        return (abs(run["loss"] - plain["loss"]) / abs(plain["loss"]),
                max((run["grads"][k] - g).abs().max().item()
                    for k, g in plain["grads"].items()) / scale)

    loss_rel, grad_rel = rel(mesh)
    spread = rel(runs["again"])
    if mesh["launches"] != I2_STEP_LAUNCHES:
        raise AssertionError(f"the 1 x 1 mesh's step launched {COUNTED} "
                             f"{mesh['launches']}, expected "
                             f"{I2_STEP_LAUNCHES}")
    if not (loss_rel <= 1e-6 and grad_rel <= 1e-6):
        raise AssertionError(f"the 1 x 1 mesh's step against the plain "
                             f"task's: loss rel {loss_rel:.2e}, gradients "
                             f"max|diff| {grad_rel:.2e} of their largest")
    log(f"  a 1 x 1 mesh in a NCCL world of one against the plain task, "
        f"nb {I2_NB}: loss rel {loss_rel:.2e}, gradients max|diff| "
        f"{grad_rel:.2e} of their largest (two plain steps: {spread[0]:.2e}"
        f", {spread[1]:.2e}); launches {mesh['launches']}")
    return ({"loss_rel": loss_rel, "grad_max_abs_diff_rel": grad_rel,
             "plain_twice_loss_rel": spread[0],
             "plain_twice_grad_max_abs_diff_rel": spread[1],
             "bitwise": loss_rel == 0.0 and grad_rel == 0.0,
             "launches": mesh["launches"]}, mesh["launches"])


def phase_freq(seed, device, ref, ssm_rows, card):
    """30. Frequency parallelism: (a) `fp_world_of_one`; (b) `fp_world`
    over gloo, four ranks on the one card (NCCL refuses two ranks on one
    device); K3/K4 at a rank's scan shapes (`ssm_rows`). Returns (report,
    launches)."""
    report, total = fp_world_of_one(seed, device)
    torch.cuda.empty_cache()
    mesh, launched = fp_world(seed, ref, card, "gloo")
    return ({"world_of_one": report, "mesh_2x2": mesh,
             "k3_k4_rank_shapes": ssm_rows},
            dict(zip(COUNTED, [a + b for a, b in zip(total, launched)])))


def fp_world(seed, ref, card, backend):
    """Four ranks as a 2 x 2 mesh, each a process of its own (this
    script with --fp-rank), DP_STEPS sharded steps of IPDnet2 at full
    width on DP_NB / 2 scenes x 128 bins a rank, against `ref`, DP_STEPS
    steps in one process on all DP_NB scenes (phase 29's): world-mean
    losses within 1e-6 relative and equal on the ranks, the first step's
    gradients within 1e-5 of their largest magnitude and the parameters
    within lr/10 (phase 29's bounds), exact launches a rank. Prints ms a
    step of a rank beside the one process's (over gloo four processes
    share the card and gloo stages through the host: no claim) and the
    bytes the freq collectives move a step. Returns (report, the ranks'
    launches summed)."""
    size = FP_MESH[0] * FP_MESH[1]
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--seed",
               str(seed), "--fp-store", f"{tmp}/store", "--fp-out", tmp,
               "--fp-backend", backend, "--fp-rank"]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd + [str(r)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(size)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        world_s = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, outs)):
            if p.returncode:
                raise AssertionError(f"freq rank {r} failed ({p.returncode})"
                                     f":\n{text[-4000:]}")
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(size)]
        got = torch.load(Path(tmp) / "ipdnet2.pt")
    per_rank = [n * DP_STEPS for n in I2_STEP_LAUNCHES]
    launched = [rk["launches"] for rk in ranks]
    if launched != [per_rank] * size:
        raise AssertionError(f"the 2 x 2 mesh launched {COUNTED} {launched}"
                             f" a rank, expected {per_rank} each")
    if any(rk["losses"] != ranks[0]["losses"] for rk in ranks):
        raise AssertionError(f"the ranks' world losses differ: {ranks}")
    lr = DP_LR["ipdnet2"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(ranks[0]["losses"], ref["losses"]))
    dp = {k: (got["params"][k] - v).abs().max().item()
          for k, v in ref["params"].items()}
    worst = max(dp, key=dp.get)
    scale = max(g.abs().max().item() for g in ref["grads"].values())
    dg = {k: (got["grads"][k] - g).abs().max().item() / scale
          for k, g in ref["grads"].items()}
    worst_g = max(dg, key=dg.get)
    if not (loss_rel <= 1e-6 and dg[worst_g] <= 1e-5
            and dp[worst] <= lr / 10):
        raise AssertionError(
            f"the 2 x 2 mesh against one process: loss rel {loss_rel:.2e}, "
            f"first step's gradients max|diff| {dg[worst_g]:.2e} of their "
            f"largest ({worst_g}), params max|diff| {dp[worst]:.2e} "
            f"({worst}; lr {lr})")
    rank_ms = float(np.mean([np.mean(rk["ms"][1:]) for rk in ranks]))
    one_ms = float(np.mean(ref["ms"][1:]))
    freq_bytes = ranks[0]["freq_bytes"] / DP_STEPS
    report = {
        "backend": backend, "loss_rel": loss_rel, "grad_max_abs_diff_rel": dg[worst_g],
        "grad_worst": worst_g, "grad_scale": scale,
        "param_max_abs_diff": dp[worst], "param_worst": worst,
        "losses_mesh": ranks[0]["losses"], "losses_one": ref["losses"],
        "ms_rank": [rk["ms"] for rk in ranks], "ms_one": ref["ms"],
        "ms_rank_mean": rank_ms, "ms_one_mean": one_ms,
        "freq_bytes_a_step": freq_bytes,
        "freq_calls_a_step": ranks[0]["freq_calls"] / DP_STEPS,
        "grad_all_reduce_bytes_a_step": ranks[0]["grad_bytes"],
        "launches_a_rank": per_rank, "rows_a_rank": ranks[0]["rows"],
        "coords": [rk["coords"] for rk in ranks], "world_s": world_s,
        "card": card}
    where = ("4 gloo ranks on the card" if backend == "gloo"
             else f"4 {backend} ranks, one a card")
    log(f"  2 x 2 mesh, {where}, {ranks[0]['rows']} scenes "
        f"x 128 bins a rank, against 1 x {DP_NB} scenes x 256 bins: losses "
        f"rel {loss_rel:.2e}, first step's gradients max|diff| "
        f"{dg[worst_g]:.2e} of their largest {scale:.3e} ({worst_g}), "
        f"params max|diff| {dp[worst]:.2e} = {dp[worst] / lr * 100:.2f} "
        f"lr/100 ({worst}); a step of a rank {rank_ms:.1f} ms (steps 2-"
        f"{DP_STEPS}) against {one_ms:.1f} "
        f"ms in one process; freq collectives {freq_bytes / 1e6:.3f} MB in "
        f"{ranks[0]['freq_calls'] // DP_STEPS} calls a step a rank, the "
        f"gradient all-reduce {ranks[0]['grad_bytes'] / 1e6:.3f} MB; "
        f"launches {per_rank} a rank; the world {world_s:.1f} s, process "
        f"start included; {card}")
    return report, [sum(col) for col in zip(*launched)]


def freq_cards(seed, out):
    """--freq-cards: on a host of four cards, fp_world over NCCL (rank r
    on cuda:r) against DP_STEPS one-process steps on cuda:0, and nothing
    else; writes OUT/freq_cards.json. Not part of the smoke test, which
    needs one card."""
    from fnssl_tpu_torch.kernels import cuda_build

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        sys.exit("chip_smoke --freq-cards: needs four CUDA devices")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = "; ".join(smi.stdout.strip().splitlines())
    log(card)
    cuda_build.build(["ssm_scan"])
    state, step, batch = dp_setup("ipdnet2", seed, torch.device("cuda", 0))
    state, losses, ms, grads = dp_steps(state, step, batch)
    ref = {"losses": losses, "ms": ms, "grads": grads,
           "params": {k: v.cpu() for k, v in
                      state.module.state_dict().items()}}
    del state, step, batch
    torch.cuda.empty_cache()
    report, _ = fp_world(seed, ref, card, "nccl")
    Path(out).mkdir(parents=True, exist_ok=True)
    (Path(out) / "freq_cards.json").write_text(json.dumps(report, indent=1))


# --------------------------------------------------------------------------
# phase 33: IPDnet2 with its MHSA and retention time modules served: the
# two variants whose output depends on the stream's position, through
# export, `serve --artifact` and the slot pool
TIME_SERVING = (("mhsa(251)", "ALiBi"), ("ret(2)", True))
TS_SHAPE = (1, 10, 256, 5)         # phase 24's IPDnet2 chunk: rows, C, F, T
TS_ART_CHUNKS = 8                  # chunk steps through the artifacts
TS_STREAM_CHUNKS = 6               # chunk steps a stream of the pool run
TS_SERVE_AUDIO_S = 2.0            # the serve --artifact connection (20 steps)
TS_RATE_CHUNKS = 240              # timed chunk steps a stream at 16 slots


def ts_schedule():
    """The pool run's ticks, as {stream: chunk index} a tick: stream 0
    alone on tick 0 (tier 1); streams 1-3 join on tick 1 while stream 0
    idles (tier 4, a padded row); 4-15 join on tick 2 (tier 16); from
    then streams 0-15 idle on every third tick ((t + k) % 3 == 1); stream 0
    ends after TS_STREAM_CHUNKS chunks, and stream 16 leases a slot on
    the next tick: every slot has been leased by then, so it takes one
    that a finished stream released. Returns the ticks and each stream's
    join tick."""
    joins = {0: 0, **{k: 1 for k in (1, 2, 3)},
             **{k: 2 for k in range(4, SLOTS)}}
    done, ticks, t = {k: 0 for k in range(SLOTS + 1)}, [], 0
    while any(n < TS_STREAM_CHUNKS for n in done.values()):
        if done[0] == TS_STREAM_CHUNKS and SLOTS not in joins:
            joins[SLOTS] = t
        tick = {}
        for k, j in joins.items():
            if t < j or done[k] == TS_STREAM_CHUNKS or (
                    t > j and k < SLOTS and (t + k) % 3 == 1):
                continue
            tick[k] = done[k]
            done[k] += 1
        ticks.append(tick)
        t += 1
    return ticks, joins


def phase_time_serving(seed, device, card, tmp):
    """Phase 33, for each of TIME_SERVING at full width, weights from
    `seed`: (a) export_model of forward and stream artifacts for cuda,
    each loaded on the card: the forward artifact against the module
    (1e-5), the stream artifact chunk by chunk (phase 24's chunk shape)
    against the module's own chunk steps (1e-5) and its one-shot forward
    (STREAM_TOL); one `serve --artifact` TCP connection against a
    dedicated stream of the same audio (1e-3); export seconds, ms a call
    of each artifact and of the module. (b) A 16-slot BatchedStreamPool
    from `_resolve` (the per-row state), warmup() capturing tiers 1, 4
    and 16 as CUDA graphs; the streams of ts_schedule() through pool
    sessions, each chunk's output against a dedicated stream of the same
    chunks on the card (1e-3); no wrapper launch in the live ticks, every
    tick a replay; each tier's replay against the tier run eagerly
    (tier_checks, 1e-6); the ms a tick a tier and the aggregate chunk
    steps a second of 16 streams at once."""
    from concurrent.futures import ThreadPoolExecutor

    from fnssl_tpu_torch.cli.main import build_parser, build_server
    from fnssl_tpu_torch.models.spatialnet import (
        SpatialNet, SpatialNetConfig, init_spatialnet_state)
    from fnssl_tpu_torch.runtime.export import (_resolve, export_model,
                                                load_artifact)
    from fnssl_tpu_torch.runtime.server import stream_client
    from fnssl_tpu_torch.runtime.slots import BatchedStreamPool
    from fnssl_tpu_torch.runtime.streaming import (
        StreamingLocalizer, make_spatialnet_stream_step)

    counters = launch_counters()
    for c in counters:
        c.reset()

    def dedicated(net, chunks):
        """The module's own chunk steps at batch 1 (JAX's state leaves)."""
        state = init_spatialnet_state(1, net.cfg, device)
        outs = []
        with torch.no_grad():
            for c in chunks:
                o, state = net(c.to(device), state=state, return_state=True)
                outs.append(o.cpu())
        return outs

    report = {}
    gen = torch.Generator().manual_seed(seed + 33)
    for attention, rope in TIME_SERVING:
        name = f"{attention} rope={rope}"
        cfg = SpatialNetConfig(attention=attention, rope=rope)
        net = SpatialNet(cfg, device=device, generator=torch.Generator()
                         .manual_seed(seed)).eval()
        kind = cfg.time_kind
        row, t_part = {}, time.perf_counter()
        # (a) the artifacts
        nt = TS_SHAPE[-1]
        x = torch.randn(TS_SHAPE[:-1] + (nt * TS_ART_CHUNKS,), generator=gen)
        chunks = [x[..., k * nt:(k + 1) * nt] for k in range(TS_ART_CHUNKS)]
        arts = {}
        for mode in ("forward", "stream"):
            out = tmp / f"ts_{kind}_{mode}"
            t0 = time.perf_counter()
            export_model("ipdnet2", net, (x if mode == "forward"
                                          else chunks[0]).numpy(), str(out),
                         mode=mode, platforms=[EXPORT_PLATFORM])
            row[f"export_{mode}_s"] = time.perf_counter() - t0
            arts[mode] = load_artifact(str(out), device)
        with torch.no_grad():
            oneshot = net(x.to(device)).cpu()
        row["forward_max_abs_err"] = (arts["forward"](x).cpu() - oneshot
                                      ).abs().max().item()
        steps = dedicated(net, chunks)
        got = [arts["stream"](c).cpu() for c in chunks]
        row["stream_max_abs_err"] = max((g - w).abs().max().item()
                                        for g, w in zip(got, steps))
        row["stream_vs_oneshot_max_abs_err"] = (
            torch.cat(got, 1) - oneshot).abs().max().item()
        tol = STREAM_TOL[kind]
        if not (row["forward_max_abs_err"] <= 1e-5
                and row["stream_max_abs_err"] <= 1e-5
                and row["stream_vs_oneshot_max_abs_err"] <= tol):
            raise AssertionError(f"{name} artifacts: {row} (tols 1e-5, "
                                 f"1e-5, {tol})")
        state = [init_spatialnet_state(1, cfg, device)]

        def module_step(c):
            o, state[0] = net(c, state=state[0], return_state=True)
            return o

        cd = chunks[0].to(device)
        row.update(forward_artifact_ms=host_ms(arts["forward"], x),
                   forward_module_ms=host_ms(net, x.to(device)),
                   stream_artifact_ms=host_ms(arts["stream"].clone(),
                                              chunks[0]),
                   stream_module_ms=host_ms(module_step, cd))
        row["artifacts_s"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # one `serve --artifact` connection against a dedicated stream of
        # the same audio through the same front end
        server, info = quiet(build_server, build_parser().parse_args(
            ["serve", "--artifact", str(tmp / f"ts_{kind}_stream"),
             "--port", "0"]))
        served = []
        make_session = server.session_factory

        def recorded_session():
            loc, decode = make_session()
            step = loc.model_step

            def wrapped(feats):
                out = step(feats)
                served.append(out.cpu())
                return out

            loc.model_step = wrapped
            return loc, decode

        server.session_factory = recorded_session
        server.start()
        audio = make_audio(seed + 700, 3, 5, TS_SERVE_AUDIO_S)
        try:
            msgs = stream_client("127.0.0.1", server.port, audio, block=1600)
        finally:
            server.shutdown()
        n = chunk_steps("ipdnet2", int(TS_SERVE_AUDIO_S * FS))
        loc = StreamingLocalizer(
            make_spatialnet_stream_step(net), nch=5, device="cpu",
            ch_mode="none", hop=320, center=True, sample_length=249,
            frames_per_step=nt)
        want = [o.cpu() for start in range(0, audio.shape[0], 1600)
                for o in loc.push(audio[start:start + 1600])]
        if msgs[-1] != {"eof": True, "outputs": n} or len(served) != n \
                or len(want) != n:
            raise AssertionError(f"{name} serve --artifact: {msgs[-1]}, "
                                 f"{len(served)} steps served, {len(want)} "
                                 f"dedicated, expected {n}")
        row["serve_artifact_max_abs_err"] = max(
            (g - w).abs().max().item() for g, w in zip(served, want))
        if not row["serve_artifact_max_abs_err"] <= 1e-3:
            raise AssertionError(f"{name} serve --artifact: max|diff| "
                                 f"{row['serve_artifact_max_abs_err']} vs "
                                 "its dedicated stream")
        row["serve_artifact_s"] = time.perf_counter() - t_part
        log(f"  {name}: export forward {row['export_forward_s']:.2f} s, "
            f"stream {row['export_stream_s']:.2f} s; forward artifact vs "
            f"module max|diff| {row['forward_max_abs_err']:.2e}; stream "
            f"artifact vs the module's chunk steps "
            f"{row['stream_max_abs_err']:.2e}, vs one-shot "
            f"{row['stream_vs_oneshot_max_abs_err']:.2e} (tol {tol}); a call"
            f": forward {row['forward_artifact_ms']:.3f} ms (module "
            f"{row['forward_module_ms']:.3f}) at {list(x.shape)}, chunk "
            f"step {row['stream_artifact_ms']:.3f} ms (module "
            f"{row['stream_module_ms']:.3f}); serve --artifact "
            f"({info['serving']}) {n} chunk steps vs a dedicated stream "
            f"{row['serve_artifact_max_abs_err']:.2e}; seconds: artifacts "
            f"{row['artifacts_s']:.1f}, serve --artifact "
            f"{row['serve_artifact_s']:.1f}; {card}")
        del arts

        # (b) the pool
        apply_fn, init_state = _resolve("ipdnet2", net)
        t0 = t_part = time.perf_counter()
        pool = BatchedStreamPool(apply_fn, net, init_state,
                                 feats_shape=TS_SHAPE, slots=SLOTS).warmup()
        row["capture_s"] = time.perf_counter() - t0
        st = pool.stepper
        try:
            if sorted(st._tiers) != [1, 4, SLOTS] \
                    or None in st._tiers.values():
                raise AssertionError(f"{name} pool tiers {st._tiers}")
            ticks, joins = ts_schedule()
            feats = {k: [torch.randn(TS_SHAPE, generator=gen)
                         for _ in range(TS_STREAM_CHUNKS)] for k in joins}
            outs = {k: [] for k in joins}
            sessions, relet = {}, None
            n0 = [c.value for c in counters]
            replays0, ticks0 = dict(st.replays), pool.ticks
            with ThreadPoolExecutor(SLOTS) as ex:
                for t, tick in enumerate(ticks):
                    for k, j in joins.items():
                        if j == t:
                            sessions[k] = pool.session()
                    if SLOTS in sessions and relet is None:
                        relet = sessions[SLOTS]._slot
                    live = list(tick.items())
                    for (k, i), o in zip(live, ex.map(
                            lambda ki: sessions[ki[0]](feats[ki[0]][ki[1]]),
                            live)):
                        outs[k].append(o)
                    for k in list(sessions):
                        if len(outs[k]) == TS_STREAM_CHUNKS:
                            sessions.pop(k).close()
            wrapped = [c.value - n for c, n in zip(counters, n0)]
            replays = {s: st.replays[s] - replays0[s] for s in st.tier_sizes}
            live_ticks = pool.ticks - ticks0
            if any(wrapped) or sum(replays.values()) != live_ticks:
                raise AssertionError(f"{name} pool: wrapper launches "
                                     f"{wrapped}, replays {replays}, ticks "
                                     f"{live_ticks}")
            errs = [max((g - w).abs().max().item() for g, w in zip(
                outs[k], dedicated(net, feats[k]))) for k in joins]
            if not max(errs) <= 1e-3:
                raise AssertionError(f"{name} pool: max|diff| vs dedicated "
                                     f"streams {errs}")
            tiers, _ = tier_checks(st, 1, TS_SHAPE[1:], device,
                                   lambda s: [0] * len(COUNTED))
            # 16 streams at once, each its chunks back to back; the clock
            # starts once every stream has stepped (threads up, first
            # dispatch done) and stops when the last has its last chunk
            rate = [pool.session() for _ in range(SLOTS)]
            chunk = torch.randn(TS_SHAPE, generator=gen)
            started = threading.Barrier(SLOTS + 1)

            def run(sess):
                try:
                    sess(chunk)
                except BaseException:
                    started.abort()     # the main thread's wait raises
                    raise
                started.wait(timeout=300)
                for _ in range(TS_RATE_CHUNKS):
                    sess(chunk)
                sess.close()

            with ThreadPoolExecutor(SLOTS) as ex:
                done = [ex.submit(run, sess) for sess in rate]
                started.wait(timeout=300)
                t0 = time.perf_counter()
                for f in done:
                    f.result()
                wall = time.perf_counter() - t0
        finally:
            pool.close()
        row.update(pool_s=time.perf_counter() - t_part,
                   pool_ticks=live_ticks, pool_replays=replays,
                   pool_max_abs_err_vs_dedicated=max(errs), tiers=tiers,
                   rate_wall_s=wall,
                   chunk_steps_per_s=SLOTS * TS_RATE_CHUNKS / wall)
        log(f"  {name} pool: captured tiers {st.tier_sizes} in "
            f"{row['capture_s']:.2f} s; {len(joins)} streams of "
            f"{TS_STREAM_CHUNKS} chunks over {live_ticks} ticks (staggered "
            f"joins, idle slots, slot {relet} leased again on tick "
            f"{joins[SLOTS]}), replays {replays}, no wrapper launch; vs "
            f"dedicated streams max|diff| {max(errs):.2e}; ms a tick "
            + ", ".join(f"tier {s} {v['ms_mean']:.3f} (p90 "
                        f"{v['ms_p90']:.3f}, replay vs eager "
                        f"{v['replay_vs_eager_max_abs_err']:.1e})"
                        for s, v in tiers.items())
            + f"; {SLOTS} streams x {TS_RATE_CHUNKS} chunks (after a first "
            f"step each) in {wall:.2f} s "
            f"= {row['chunk_steps_per_s']:.1f} chunk steps/s; the pool part "
            f"{row['pool_s']:.1f} s; {card}")
        report[name] = row
        del net, pool
        torch.cuda.empty_cache()
    launched = [c.value for c in counters]
    if any(launched):
        raise AssertionError(f"time-module serving launched {COUNTED} "
                             f"{launched}, expected none")
    return report, dict(zip(COUNTED, launched))


def locata_k1(rows, frames):
    """K1's numbers over one `locata --model fnssl` recording, fp32: 3
    full-band BiLSTMs (one launch each) and 3 narrow-band LSTMs."""
    full, narrow = rows
    b = bound({k: 3 * (2 * full["bound_terms_float32"][k]
                       + narrow["bound_terms_float32"][k])
               for k in ("bytes", "operations")})
    return {"ms": 3 * (full["fused_ms_float32"] + narrow["ms_float32"]),
            "ms_bf16": 3 * (full["fused_ms_bfloat16"]
                            + narrow["ms_bfloat16"]),
            "plain_ms": 3 * (full["fused_plain_ms"] + narrow["plain_ms"]),
            "bound_ms": b[0], "bound_by": b[1],
            "library_ms": 3 * (full["library_bidir_ms"]
                               + narrow["library_ms"]),
            "work": f"the recurrences of one LOCATA recording ({frames} "
                    f"frames), fp32: 3 full-band BiLSTMs (T=256, "
                    f"B={frames}, H=128) and 3 narrow-band LSTMs "
                    f"(T={frames}, B=256, H=256)",
            "launches_per_recording": LOCATA_LAUNCHES[0]}


def per_train_step(rows, key):
    """A per-shape number summed over one train step's launches."""
    return PER_TRAIN_STEP * sum(r[key] for r in rows)


def step_bound(rows, key):
    return bound({k: PER_TRAIN_STEP * sum(r[key][k] for r in rows)
                  for k in ("bytes", "operations")})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--out", default="results/chip_smoke",
                    help="where the full report (JSON) is written")
    ap.add_argument("--dp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)     # phase 29's rank processes
    ap.add_argument("--dp-store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--fp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)     # phase 30's rank processes
    ap.add_argument("--fp-store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--fp-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--fp-backend", default="gloo", help=argparse.SUPPRESS)
    ap.add_argument("--freq-cards", action="store_true",
                    help="on four cards: phase 30's 2 x 2 mesh over NCCL, "
                         "one rank a card, and nothing else")
    args = ap.parse_args()
    if args.dp_rank is not None:
        return dp_rank(args.dp_rank, args.dp_store, args.dp_out, args.seed)
    if args.fp_rank is not None:
        return fp_rank(args.fp_rank, args.fp_store, args.fp_out, args.seed,
                       args.fp_backend)
    if args.freq_cards:
        return freq_cards(args.seed, args.out)

    # 1. device
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this smoke test runs only on "
                 "the card")
    import fnssl_tpu_torch  # fails outside the checkout
    if Path(fnssl_tpu_torch.__file__).resolve().parents[1] != ROOT:
        sys.exit(f"chip_smoke: fnssl_tpu_torch comes from "
                 f"{fnssl_tpu_torch.__file__}, not from this checkout")
    from fnssl_tpu_torch.kernels import cuda_build
    from fnssl_tpu_torch.kernels import lstm_cuda as L

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
    reports = cuda_build.build(["lstm_cluster", "lstm_wave", "lstm_wide",
                                "lstm_bwd_cluster", "lstm_bwd_wave",
                                "lstm_bwd_wide", "ssm_scan"])
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        spills = [line.strip() for line in report.splitlines()
                  if re.search(r"[1-9]\d* bytes spill stores", line)]
        log(f"  {name}: {len(spills)} kernel instances spill"
            + "".join(f"\n    {line}" for line in spills))

    # the synthetic LOCATA tree of phase 26, written first: phase 3 holds K1
    # at its frame count; phase 10's corpus and runs stay in `work` for
    # phases 26 and 28
    work_dir = tempfile.TemporaryDirectory()
    work = Path(work_dir.name)
    t0 = time.perf_counter()
    write_locata(work / "locata", args.seed)
    frames = locata_frames(work / "locata")
    log(f"[locata tree] {len(LOCATA_TASKS) * len(LOCATA_RECORDINGS)} "
        f"recordings of {LOCATA_S} s, 15 channels at {LOCATA_FS} Hz: "
        f"{frames} frames each; {time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions
    log("[kernels] K1 against its plain version on the card")
    worst = phase_kernels(device, locata_shapes(frames))

    # 4. serve
    log("[serve] cli serve --model fnssl on the card, 3 TCP connections")
    launches, steps, step = phase_serve(args.seed, device)

    # 5. times
    log("[times] K1 at the main path's shapes")
    rows = phase_times(device)
    log("[plans] lstm_cluster plans at FN-SSL's and IPDnet's serve shapes, "
        "fp32")
    plans = phase_plans(device, SHAPES[:2] + IPD_FWD_SHAPES[:2])
    log("[wave] lstm_wave.cu at FN-SSL's narrow band beside lstm_cluster.cu, "
        "the bound and cuDNN (TF32 off and on), the card's time from a trace")
    wave_rows = phase_wave_times(device)
    log(f"[wave sweep] lstm_wave.cu against lstm_cluster.cu: B {SWEEP_B} x H "
        f"{SWEEP_H} x 1-2 directions x fp32/bf16 x T {SWEEP_T}")
    sweep_rows, sweep_measured = phase_wave_sweep(device)

    # 6-9. training
    log("[backward] K2 against its plain version on the card; K1 at the "
        "training shapes and at a DP rank's")
    worst_bwd, bwd_checks = phase_backward(
        device, worst, TRAIN_SHAPES + DP_RANK_SHAPES + WIDE_TRAIN_SHAPES)
    refused = refusals(device)
    log(f"[train parity] one fp32 train step, nb={PARITY_NB} x {TRAIN_T_S} s,"
        " dropout off: the card against the CPU")
    parity = phase_train_parity(args.seed, device)
    log(f"[train] nb={TRAIN_NB} x {TRAIN_T_S} s, FNSSLConfig(), Adam 1e-3 / "
        "gamma 0.8988, dropout on: fp32, then the bf16 policy")
    train, train_launches = phase_train(args.seed, device)
    log("[train times] K1, K2 and the LSTM backward at the training shapes")
    train_rows = phase_train_times(device)
    check_k2_target(train_rows)
    log("[bwd plans] lstm_bwd_cluster plans at the training shapes")
    bwd_plans = phase_bwd_plans(device)
    log(f"[bwd sweep] lstm_bwd_wave.cu against lstm_bwd_cluster.cu: T "
        f"{BWD_SWEEP_T}, B {BWD_SWEEP_B} x H {BWD_SWEEP_H} x 1-2 directions "
        "x fp32/bf16")
    bwd_sweep, bwd_measured = phase_bwd_sweep(device)
    log(f"[wide times] K1 and K2 at FN-SSL's hidden_size {WIDE_HIDDEN} "
        "shapes and K1's small-B check case above H = 256: the card's time "
        "from a trace, bound and K2's share of it, K2's plan above H = 256, "
        "plain, cuDNN (fp32 with TF32 off and on, and bf16: cuDNN's bf16 "
        "recurrence, not the float32 function)")
    wide_rows = phase_wide_times(device)

    # 10. the user's training loop through the CLI
    log(f"[fit] cli simulate -> fit -> test -> serve at full width: "
        f"{FIT_TRAIN}+{FIT_DEV} scenes of {TRAIN_T_S} s, bz {FIT_BZ}, fnssl "
        f"{FIT_EPOCHS} epochs, fnssl_doa 1")
    fit_report, fit_launches = phase_fit(args.seed, device, card,
                                         train["fp32"]["ms_mean"], work)

    # 11-16. IPDnet
    log("[ipdnet kernels] K1 and K2 at IPDnet's shapes against their plain "
        "versions")
    ipd_checks = phase_ipdnet_kernels(device, worst, worst_bwd, bwd_checks)
    log(f"  {ipd_checks} K1 checks; worst K1 {json.dumps(worst)}, K2 "
        f"{json.dumps(worst_bwd)}")
    log("[ipdnet plans] every lstm_cluster and lstm_bwd_cluster plan at "
        "IPDnet's training shapes")
    ipd_plans = phase_plans(device, IPD_TRAIN_SHAPES,
                            ("float32", "bfloat16"), iters=5)
    ipd_bwd_plans = phase_bwd_plans(device, IPD_TRAIN_SHAPES)
    log("  and every lstm_cluster plan at FN-SSL's training full band (its "
        "narrow band runs on lstm_wave.cu)")
    train_plans = phase_plans(device, TRAIN_SHAPES[:1],
                              ("float32", "bfloat16"), iters=5)
    picks = {"serve_k1": plan_picks(plans, "K1"),
             "fnssl_train_k1": plan_picks(train_plans, "K1"),
             "fnssl_train_k2": plan_picks(bwd_plans, "K2"),
             "ipdnet_train_k1": plan_picks(ipd_plans, "K1"),
             "ipdnet_train_k2": plan_picks(ipd_bwd_plans, "K2")}
    log("[ipdnet serve] cli serve --model ipdnet on the card, 3 TCP "
        "connections")
    ipd_launches, ipd_steps, ipd_serve = phase_serve(args.seed, device,
                                                     "ipdnet")
    log("[ipdnet times] K1 and K2 at IPDnet's shapes")
    ipd_rows = phase_times(device, IPD_FWD_SHAPES)
    ipd_train_rows = phase_train_times(device, IPD_TRAIN_SHAPES,
                                       k2_turns=False)
    log(f"[ipdnet parity] one fp32 train step of each IPDnet task, "
        f"nb={IPD_PARITY_NB} x {IPD_T_S} s (variable: nch {IPD_VAR_NCH}, nb "
        f"1), dropout off: the card against the CPU")
    ipd_parity = phase_ipdnet_parity(args.seed, device)
    log(f"[ipdnet train] ipdnet nb={IPD_NB} and variable_ipdnet nb="
        f"{IPD_VAR_NB} (nch {IPD_VAR_NCH}) x {IPD_T_S} s, Adam 5e-4 / gamma "
        "0.975, dropout on: fp32, then the bf16 policy")
    ipd_train, ipd_train_launches = phase_ipdnet_train(args.seed, device)
    log(f"[ipdnet fit] cli simulate --preset ipdnet -> fit -> test -> serve: "
        f"{IPD_FIT_TRAIN}+{IPD_FIT_DEV} scenes of {IPD_T_S} s, bz {IPD_NB}; "
        "ipdnet 2 epochs, ipdnet_offline 1, variable_ipdnet 1")
    ipd_fit, ipd_fit_launches = phase_ipdnet_fit(args.seed, device, card)

    # 17-21. IPDnet2
    log("[ipdnet2 kernels] K3 and K4 against their plain versions at every "
        "scan shape")
    ssm_worst, ssm_checks = phase_ssm_kernels(device, SSM_DP_SHAPES
                                              + SSM_FP_SHAPES)
    log("[ipdnet2 serve] cli serve --model ipdnet2 on the card, 3 TCP "
        "connections of 5-channel audio")
    i2_launches, i2_steps, i2_serve = phase_serve(args.seed, device,
                                                  "ipdnet2")
    log("[ipdnet2 times] K3 and K4 a launch, bound and plain version")
    ssm_rows = phase_ssm_times(device)
    log(f"[ipdnet2 parity] one fp32 train step, nb={I2_PARITY_NB} x {I2_T_S} "
        "s: the card against the CPU")
    i2_parity = phase_ipdnet2_parity(args.seed, device)
    log(f"[ipdnet2 train] nb={I2_NB} x {I2_T_S} s, AdamW 5e-4 / gamma 0.975, "
        f"clip 5: fp32, then the bf16 policy; the forward at nt={I2_FWD_NT}")
    i2_train, i2_train_launches = phase_ipdnet2_train(args.seed, device)
    log(f"[ipdnet2 fit] a RealMAN-layout corpus ({I2_FIT_TRAIN}+{I2_FIT_DEV} "
        f"recordings) -> fit {I2_FIT_EPOCHS} epochs -> test -> test --best ->"
        " serve")
    i2_fit, i2_fit_launches = phase_ipdnet2_fit(args.seed, device, card)

    # 22-25. the inference entry points
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        log("[predict] cli predict of fnssl, fnssl_doa, ipdnet, ipdnet2 and "
            "ipd_baseline on a 5 s wav: the card against the CPU")
        predict_report, predict_launches = phase_predict(args.seed, device,
                                                         tmp)
        log("[stream] cli stream of each causal model: RTF, and each chunk "
            "against the serve path's")
        stream_report, stream_launches = phase_stream(args.seed, device, tmp)
        log(f"[slots] cli serve --slots {SLOTS} of {', '.join(SLOT_MODELS)}: "
            f"{SLOTS} concurrent TCP connections against dedicated streams")
        slots_report, slots_launches = {}, {k: 0 for k in COUNTED}
        for model in SLOT_MODELS:
            slots_report[model], launched = phase_slots(args.seed, device,
                                                        model)
            slots_launches = {k: slots_launches[k] + launched[k]
                              for k in COUNTED}
        log(f"  K1 and K3 at the {SLOTS}-slot tier's shapes")
        slot_rows = phase_times(device, SLOT_SHAPES)
        ssm_slot_rows = phase_ssm_times(device, SSM_SLOT_SHAPES)
        log("[export] cli export --platforms cuda: forward and stream "
            "artifacts against their modules; serve --artifact")
        export_report, export_launches = phase_export(args.seed, device, tmp)

    # 26-28. the last slice
    log(f"[locata] cli locata --model fnssl on the card and the CPU, and "
        f"ipd_baseline: {len(LOCATA_TASKS) * len(LOCATA_RECORDINGS)} "
        f"recordings of {LOCATA_S} s")
    locata_report, locata_launches = phase_locata(
        args.seed, device, work / "locata", work / "runs", frames, card)
    log("[time modules] IPDnet2 with MHSA and retention time modules: "
        "forward, streaming, train parity and train cell")
    time_report, time_launches = phase_time_modules(
        args.seed, device, i2_train["fp32"]["ms_mean"], card)
    log(f"[fit flags] fit --model fnssl on phase 10's corpus ({FIT_TRAIN} "
        "scenes, one epoch): plain, --profile 1, --debug-nans")
    flags_report, flags_launches = phase_fit_flags(
        args.seed, device, work / "data", work / "runs", card)
    log(f"[dp] fit --use-mesh (a NCCL world of one) on phase 10's corpus; "
        f"2 gloo ranks on the card, {DP_STEPS} DDP steps of FN-SSL and "
        f"IPDnet2 at {DP_NB // 2} scenes a rank against one process at "
        f"{DP_NB}")
    dp_report, dp_launches, dp_ref = phase_dp(args.seed, device,
                                              work / "data", work / "runs",
                                              card)
    work_dir.cleanup()
    log(f"[freq] a 1 x 1 mesh in a NCCL world of one; 4 gloo ranks on the "
        f"card as a {FP_MESH[0]} x {FP_MESH[1]} mesh, {DP_STEPS} sharded "
        f"IPDnet2 steps at {DP_NB // FP_MESH[0]} scenes x 128 bins a rank "
        f"against phase 29's one process at {DP_NB}; K3/K4 at a rank's "
        "scan shapes")
    fp_ssm_rows = phase_ssm_times(device, SSM_FP_SHAPES)
    fp_report, fp_launches = phase_freq(args.seed, device, dp_ref,
                                        fp_ssm_rows, card)

    # 31-32. the widths of this slice
    log(f"[fnssl hidden {WIDE_HIDDEN}] FNSSLConfig(hidden_size="
        f"{WIDE_HIDDEN}): one fp32 train step (nb={WIDE_PARITY_NB} x "
        f"{WIDE_PARITY_T_S} s) against the CPU; the cell nb={WIDE_NB} x "
        f"{TRAIN_T_S} s, fp32 then bf16, and a traced step of each")
    wide_report, wide_launches = phase_wide_train(args.seed, device)
    log(f"[ipdnet2 {I2_D32_ATTENTION}] SpatialNetConfig(attention="
        f"{I2_D32_ATTENTION!r}): one fp32 train step (nb={I2_PARITY_NB}) "
        f"against the CPU; the cell nb={I2_NB} x {I2_T_S} s, fp32 then bf16; "
        "K3/K4 at its scan shapes")
    d32_report, d32_launches = phase_ipdnet2_d32(args.seed, device)

    # 33. IPDnet2's MHSA and retention time modules served
    log(f"[time-module serving] IPDnet2 with "
        f"{', '.join(f'{a} rope={r}' for a, r in TIME_SERVING)}: forward and "
        f"stream artifacts for cuda against the module, serve --artifact, "
        f"a {SLOTS}-slot pool of CUDA graphs against dedicated streams")
    with tempfile.TemporaryDirectory() as tmp:
        ts_report, ts_launches = phase_time_serving(args.seed, device, card,
                                                    Path(tmp))

    # lstm_wide.cu's and lstm_bwd_wide.cu's work in one train step of FN-SSL
    # at hidden_size 512, nb 16, fp32: the 3 narrow-band LSTMs (298, 4096,
    # 512) their rules give them
    wide = {r["shape"]: r for r in wide_rows}
    wn = wide["wide_narrowband"]

    def wide_share(k, library):
        b = bound({t: 3 * v for t, v in
                   wn[f"{k}_bound_terms_float32"].items()})
        return {"ms": 3 * wn[f"{k}_ms_float32"],
                "ms_bf16": 3 * wn[f"{k}_ms_bfloat16"],
                "replaces": ("fnssl_tpu/kernels/lstm_pallas.py:50"
                             if k == "k1" else
                             "fnssl_tpu/kernels/lstm_pallas.py:269"),
                "plain_ms": 3 * wn[f"{k}_plain_ms"],
                "bound_ms": b[0], "bound_by": b[1],
                "library_ms": 3 * wn[library],
                "library_tf32_ms": 3 * wn[f"{library}_tf32"],
                "library_bf16_ms": 3 * wn[f"{library}_bf16"],
                "work": f"the 3 launches of one FN-SSL train step at "
                        f"hidden_size {WIDE_HIDDEN}, nb={WIDE_NB}, fp32, that "
                        f"the rule gives this kernel: 3 x (T={wn['T']}, "
                        f"B={wn['B']}, H={wn['H']}, ndir=1); ms is the card's "
                        "time from a trace (ms_bf16 the same launches in "
                        "bf16); library_ms is nn.LSTM (cuDNN) on the same "
                        "shapes with TF32 off (the port's float32; the "
                        "backward: forward+backward less forward), "
                        "library_tf32_ms with it on, library_bf16_ms in "
                        "bf16 (cuDNN's bf16 recurrence on the tensor cores, "
                        "not the float32 products JAX's _lstm_backward and "
                        "the port compute)"}

    def wide_case(k, library):
        v = wide["v2_case"]
        return {"T": v["T"], "B": v["B"], "H": v["H"],
                "ms": v[f"{k}_ms_float32"], "ms_bf16": v[f"{k}_ms_bfloat16"],
                "plain_ms": v[f"{k}_plain_ms"],
                "bound_ms": v[f"{k}_bound_ms"],
                "bound_by": v[f"{k}_bound_by"], "library_ms": v[library],
                "library_tf32_ms": v[f"{library}_tf32"],
                "library_bf16_ms": v[f"{library}_bf16"]}

    # each kernel's work in one online chunk step, fp32: 3 BiLSTMs over
    # frequency and 3 LSTMs over time
    serve = {r["shape"]: r for r in rows if r["shape"] in PER_CHUNK}
    full, narrow = serve["serve_fullband"], serve["serve_narrowband"]
    nf, nn_ = PER_CHUNK["serve_fullband"], PER_CHUNK["serve_narrowband"]
    serve_bound = bound(
        {k: 2 * nf * full["bound_terms_float32"][k]
         + nn_ * narrow["bound_terms_float32"][k]
         for k in ("bytes", "operations")})
    serve_common = {
        "plain_ms": nf * full["fused_plain_ms"] + nn_ * narrow["plain_ms"],
        "bound_ms": serve_bound[0], "bound_by": serve_bound[1],
        "library_ms": (nf * full["library_bidir_ms"]
                       + nn_ * narrow["library_ms"]),
        "work": "the recurrences of one online chunk step, fp32: 3 "
                "full-band BiLSTMs (T=256, B=12, H=128) and 3 narrow-band "
                "LSTMs (T=12, B=256, H=256)"}
    # and in one train step at nb=16, fp32: 3 full-band BiLSTMs (one launch
    # each) and 3 narrow-band LSTMs, forward (K1) and backward (K2)
    (_, t_f, b_f, h_f, _, _), (_, t_n, b_n, h_n, _, _) = TRAIN_SHAPES
    work = (f"one train step at nb={TRAIN_NB}, fp32: {PER_TRAIN_STEP} "
            f"full-band BiLSTMs (T={t_f}, B={b_f}, H={h_f}) and "
            f"{PER_TRAIN_STEP} narrow-band LSTMs (T={t_n}, B={b_n}, "
            f"H={h_n})")
    k1_bound = step_bound(train_rows, "k1_bound_terms_float32")
    k2_bound = step_bound(train_rows, "k2_bound_terms_float32")
    k1_common = {"replaces": "fnssl_tpu/kernels/lstm_pallas.py:50",
                 "plain_ms": per_train_step(train_rows, "k1_plain_ms"),
                 "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
                 "library_ms": per_train_step(train_rows, "library_fwd_ms"),
                 "library_tf32_ms": per_train_step(train_rows,
                                                   "library_fwd_ms_tf32"),
                 "work": work}
    # K1 in one train step as the rule splits it: all of it, and each
    # kernel's share (the launches fwd_route gives it)
    k1_train_step = {
        "ms": per_train_step(train_rows, "k1_ms_float32"),
        "ms_bf16": per_train_step(train_rows, "k1_ms_bfloat16"),
        "cluster_only_ms": per_train_step(train_rows,
                                          "k1_cluster_ms_float32"),
        **k1_common}

    def k1_share(route):
        """A K1 kernel's numbers over the launches of one train step that
        fwd_route gives it; where it gives it none, over the same step's
        recurrences forced onto it (timed beside the routed kernel)."""
        mine = [r for r in train_rows if r["k1_route"] == route]
        forced = not mine
        mine = mine or train_rows
        b = step_bound(mine, "k1_bound_terms_float32")
        return {"ms": per_train_step(mine, f"k1_{route}_ms_float32"),
                "ms_bf16": per_train_step(mine, f"k1_{route}_ms_bfloat16"),
                "replaces": "fnssl_tpu/kernels/lstm_pallas.py:50",
                "plain_ms": per_train_step(mine, "k1_plain_ms"),
                "bound_ms": b[0], "bound_by": b[1],
                "library_ms": per_train_step(mine, "library_fwd_ms"),
                "library_tf32_ms": per_train_step(mine,
                                                  "library_fwd_ms_tf32"),
                "work": (f"no launch of one train step at nb={TRAIN_NB}, "
                         "fp32, where fwd_route gives another kernel every "
                         f"recurrence; these numbers are that step's "
                         f"{PER_TRAIN_STEP * len(mine)} launches forced onto "
                         "this kernel: " if forced else
                         f"the {PER_TRAIN_STEP * len(mine)} launches of one "
                         f"train step at nb={TRAIN_NB}, fp32, that fwd_route "
                         "gives this kernel: ") + ", ".join(
                            f"{PER_TRAIN_STEP} x (T={r['T']}, B={r['B']}, "
                            f"H={r['H']}, ndir={r['ndir']})" for r in mine)
                        + "; library_ms is nn.LSTM (cuDNN) on the same "
                        "shapes with TF32 off (the port's float32), "
                        "library_tf32_ms with it on"}
    paths = {"serve": launches, "train": train_launches, "fit": fit_launches,
             "ipdnet_serve": ipd_launches, "ipdnet_train": ipd_train_launches,
             "ipdnet_fit": ipd_fit_launches, "ipdnet2_serve": i2_launches,
             "ipdnet2_train": i2_train_launches,
             "ipdnet2_fit": i2_fit_launches, "predict": predict_launches,
             "stream": stream_launches, "serve_slots": slots_launches,
             "export": export_launches, "locata": locata_launches,
             "time_modules": time_launches, "fit_flags": flags_launches,
             "data_parallel": dp_launches, "freq_parallel": fp_launches,
             "fnssl_h512_train": wide_launches,
             "ipdnet2_d32_train": d32_launches,
             "time_serving": ts_launches}
    # and in one fixed-array IPDnet train step at nb=16, fp32: 2 full-band
    # BiLSTMs and 2 narrow-band LSTMs, forward (K1) and backward (K2)
    ipd_step_rows = ipd_train_rows[:2]
    ipd_work = (f"one IPDnet train step at nb={IPD_NB}, fp32: 2 full-band "
                "BiLSTMs (T=256, B=4480, H=64) and 2 narrow-band LSTMs "
                "(T=280, B=4096, H=128)")

    def ipd_step(key):
        return 2 * sum(r[key] for r in ipd_step_rows)

    def ipd_step_bound(key):
        return bound({k: 2 * sum(r[key][k] for r in ipd_step_rows)
                      for k in ("bytes", "operations")})
    kernels = [{
        "name": "lstm_cluster", "route": "cuda",
        "source": "fnssl_tpu_torch/kernels/csrc/lstm_cluster.cu",
        "launches": sum(v["lstm_cluster"] for v in paths.values()),
        "launches_by_path": {k: v["lstm_cluster"] for k, v in paths.items()},
        "max_abs_err": worst["lstm_cluster"]["float32"],
        **k1_share("cluster"),
        "max_abs_err_bf16_ys": worst["lstm_cluster"]["bfloat16_ys"],
        "serve_chunk_step": {
            "ms": nf * full["fused_ms_float32"] + nn_ * narrow["ms_float32"],
            **serve_common, "launches_per_chunk_step": LAUNCHES_PER_CHUNK,
            "chunk_steps": steps, **step},
        "slots16": slot_rows,
        "per_shape": rows + train_rows + ipd_rows + ipd_train_rows,
        "plans": plans + train_plans + ipd_plans,
        "ipdnet_train_step": {
            "ms": ipd_step("k1_ms_float32"),
            "ms_bf16": ipd_step("k1_ms_bfloat16"),
            "plain_ms": ipd_step("k1_plain_ms"),
            "bound_ms": ipd_step_bound("k1_bound_terms_float32")[0],
            "bound_by": ipd_step_bound("k1_bound_terms_float32")[1],
            "library_ms": ipd_step("library_fwd_ms"), "work": ipd_work,
            "launches_per_train_step": IPD_LAUNCHES},
        "ipdnet_serve_chunk_step": {
            "ms": 2 * (ipd_rows[0]["fused_ms_float32"]
                       + ipd_rows[1]["ms_float32"]),
            "plain_ms": 2 * (ipd_rows[0]["fused_plain_ms"]
                             + ipd_rows[1]["plain_ms"]),
            "library_ms": 2 * (ipd_rows[0]["library_bidir_ms"]
                               + ipd_rows[1]["library_ms"]),
            **dict(zip(("bound_ms", "bound_by"), bound({k: 2 * (
                2 * ipd_rows[0]["bound_terms_float32"][k]
                + ipd_rows[1]["bound_terms_float32"][k])
                for k in ("bytes", "operations")}))),
            "work": "the recurrences of one IPDnet chunk step, fp32: 2 "
                    "full-band BiLSTMs (T=256, B=12, H=64) and 2 narrow-band "
                    "LSTMs (T=12, B=256, H=128)",
            "launches_per_chunk_step": IPD_LAUNCHES,
            "chunk_steps": ipd_steps, **ipd_serve},
        "locata_recording": locata_k1(locata_report["k1_rows"], frames),
    }, {
        "name": "lstm_wave", "route": "cuda",
        "source": "fnssl_tpu_torch/kernels/csrc/lstm_wave.cu",
        "launches": sum(v["lstm_wave"] for v in paths.values()),
        "launches_by_path": {k: v["lstm_wave"] for k, v in paths.items()},
        "max_abs_err": worst["lstm_wave"]["float32"],
        **k1_share("wave"),
        "max_abs_err_bf16_ys": worst["lstm_wave"]["bfloat16_ys"],
        "max_abs_err_bf16": worst["lstm_wave"]["bfloat16"],
        "device_ms": wave_rows, "thresholds": {
            f"H={h} itemsize={i}": n
            for (h, i), n in L.WAVE_MIN_ROWS.items()},
        "sweep": sweep_rows, "sweep_thresholds": sweep_measured,
    }, {
        "name": "lstm_wide", "route": "cuda",
        "source": "fnssl_tpu_torch/kernels/csrc/lstm_wide.cu",
        "launches": sum(v["lstm_wide"] for v in paths.values()),
        "launches_by_path": {k: v["lstm_wide"] for k, v in paths.items()},
        "max_abs_err": worst["lstm_wide"]["float32"],
        **wide_share("k1", "library_fwd_ms"),
        "max_abs_err_bf16_ys": worst["lstm_wide"]["bfloat16_ys"],
        "max_abs_err_bf16": worst["lstm_wide"]["bfloat16"],
        "v2_case": wide_case("k1", "library_fwd_ms"),
    }]
    def k2_share(route):
        """A K2 kernel's numbers over the launches of one train step that
        bwd_route gives it in fp32 (ms_bf16: the same launches in
        bf16); where it gives it none, over the same step's recurrences
        forced onto it (timed in turns with the routed kernel)."""
        mine = [r for r in train_rows if r["k2_route_float32"] == route]
        forced = not mine
        mine = mine or train_rows
        b = step_bound(mine, "k2_bound_terms_float32")
        return {"ms": per_train_step(mine, f"k2_{route}_ms_float32"),
                "ms_bf16": per_train_step(mine, f"k2_{route}_ms_bfloat16"),
                "replaces": "fnssl_tpu/kernels/lstm_pallas.py:269",
                "plain_ms": per_train_step(mine, "k2_plain_ms"),
                "bound_ms": b[0], "bound_by": b[1],
                "library_ms": per_train_step(mine, "library_bwd_ms"),
                "library_tf32_ms": per_train_step(mine,
                                                  "library_bwd_ms_tf32"),
                "lstm_backward_ms": per_train_step(mine, "port_bwd_ms"),
                "work": (f"no launch of one train step at nb={TRAIN_NB}, "
                         "fp32, where bwd_route gives another kernel every "
                         f"recurrence; these numbers are that step's "
                         f"{PER_TRAIN_STEP * len(mine)} launches forced onto "
                         "this kernel: " if forced else
                         f"the {PER_TRAIN_STEP * len(mine)} launches of one "
                         f"train step at nb={TRAIN_NB}, fp32, that bwd_route "
                         "gives this kernel: ") + ", ".join(
                            f"{PER_TRAIN_STEP} x (T={r['T']}, B={r['B']}, "
                            f"H={r['H']}, ndir={r['ndir']})" for r in mine)
                        + "; ms is the card's time from a trace (ms_bf16: "
                        "the same launches in bf16, where bwd_route may "
                        "give the other kernel); library_ms"
                        " is cuDNN's backward (forward+backward less "
                        "forward) of the same LSTMs, input gradients "
                        "included, TF32 off (the port's float32), "
                        "library_tf32_ms with it on; lstm_backward_ms is "
                        "the port's whole LSTM backward"}
    for route, src in (("cluster", "lstm_bwd_cluster"),
                       ("wave", "lstm_bwd_wave")):
        kernels.append({
            "name": src, "route": "cuda",
            "source": f"fnssl_tpu_torch/kernels/csrc/{src}.cu",
            "launches": sum(v[src] for v in paths.values()),
            "launches_by_path": {k: v[src] for k, v in paths.items()},
            "max_abs_err": worst_bwd[src]["float32"],
            "max_abs_err_bf16": worst_bwd[src]["bfloat16"],
            "checks": bwd_checks[src], **k2_share(route)})
    kernels[-2]["ipdnet_train_step"] = {
        "ms": ipd_step("k2_ms_float32"), "ms_bf16": ipd_step("k2_ms_bfloat16"),
        "plain_ms": ipd_step("k2_plain_ms"),
        "bound_ms": ipd_step_bound("k2_bound_terms_float32")[0],
        "bound_by": ipd_step_bound("k2_bound_terms_float32")[1],
        "library_ms": ipd_step("library_bwd_ms"),
        "library_tf32_ms": ipd_step("library_bwd_ms_tf32"),
        "lstm_backward_ms": ipd_step("port_bwd_ms"), "work": ipd_work,
        "routes": [r["k2_route_float32"] for r in ipd_step_rows]}
    kernels[-1].update({
        "thresholds": {f"H={h} itemsize={i}": n
                       for (h, i), n in L.BWD_WAVE_MIN_ROWS.items()},
        "sweep_thresholds": bwd_measured, "sweep": bwd_sweep,
        "k2_train_step": {
            "ms": per_train_step(train_rows, "k2_ms_float32"),
            "ms_bf16": per_train_step(train_rows, "k2_ms_bfloat16"),
            "cluster_only_ms": per_train_step(train_rows,
                                              "k2_cluster_ms_float32"),
            "bound_ms": k2_bound[0], "bound_by": k2_bound[1]}})
    kernels[-2]["plans"] = bwd_plans + ipd_bwd_plans
    # K3 and K4 over one IPDnet2 train step at nb=16 (2 scans at layer 0, T
    # 201, and 14 at T 40) and one serve chunk step (2 at L 5, 14 at L 1)
    ssm = {r["shape"]: r for r in ssm_rows + fp_ssm_rows}

    def ssm_path(key, first, later, rows=ssm):
        return 2 * rows[first][key] + 14 * rows[later][key]

    def ssm_path_bound(k, first, later, rows=ssm):
        return bound({t: 2 * rows[first][f"{k}_bound_terms_float32"][t]
                      + 14 * rows[later][f"{k}_bound_terms_float32"][t]
                      for t in ("bytes", "operations", "exponentials")})

    def bound_by(term):
        """The contract's two words: the SFU's exponentials are
        operations."""
        return "bytes" if term == "bytes" else "operations"

    for k, name, replaces in (
            ("k3", "ssm_scan_fwd", "fnssl_tpu/models/mamba.py:145"),
            ("k4", "ssm_scan_bwd", "fnssl_tpu/models/mamba.py:189")):
        step_bound_ = ssm_path_bound(k, "train_layer0", "train_layers1_7")
        fp_bound_ = ssm_path_bound(k, "fp_rank_layer0", "fp_rank_layers1_7")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fnssl_tpu_torch/kernels/csrc/ssm_scan.cu",
            "replaces": replaces, "fuses": "fnssl_tpu/models/mamba.py:80",
            "launches": sum(v[name] for v in paths.values()),
            "launches_by_path": {p: v[name] for p, v in paths.items()},
            "max_abs_err": ssm_worst[name]["float32"],
            "max_abs_err_bf16": ssm_worst[name]["bfloat16"],
            "checks": ssm_checks // 2,
            "ms": ssm_path(f"{k}_ms_float32", "train_layer0",
                           "train_layers1_7"),
            "ms_bf16": ssm_path(f"{k}_ms_bfloat16", "train_layer0",
                                "train_layers1_7"),
            "plain_ms": ssm_path(f"{k}_plain_ms", "train_layer0",
                                 "train_layers1_7"),
            "bound_ms": step_bound_[0],
            "bound_by": bound_by(step_bound_[1]), "bound_term": step_bound_[1],
            "library_ms": None,
            "work": f"one IPDnet2 train step at nb={I2_NB} x {I2_T_S} s, fp32:"
                    " 2 fused scans at B=256, L=201, d=192 (layer 0) and 14 "
                    "at L=40; no PyTorch call computes a selective scan",
            "per_shape": ssm_rows + fp_ssm_rows,
            "freq_rank_step": {
                "ms": ssm_path(f"{k}_ms_float32", "fp_rank_layer0",
                               "fp_rank_layers1_7"),
                "plain_ms": ssm_path(f"{k}_plain_ms", "fp_rank_layer0",
                                     "fp_rank_layers1_7"),
                "bound_ms": fp_bound_[0],
                "bound_by": bound_by(fp_bound_[1]),
                "library_ms": None,
                "work": "the scans of one rank's step on a 2 x 2 mesh: 2 "
                        "at B=64, L=201, d=192 and 14 at L=40",
                "launches_per_rank_step": I2_LAUNCHES}})
    serve_bound_ = ssm_path_bound("k3", "serve_layer0", "serve_layers1_7")
    kernels[-2]["serve_chunk_step"] = {
        "ms": ssm_path("k3_ms_float32", "serve_layer0", "serve_layers1_7"),
        "plain_ms": ssm_path("k3_plain_ms", "serve_layer0",
                             "serve_layers1_7"),
        "bound_ms": serve_bound_[0], "bound_by": bound_by(serve_bound_[1]),
        "work": "2 scans at B=16, L=5, d=192 and 14 at L=1",
        "launches_per_chunk_step": I2_LAUNCHES, "chunk_steps": i2_steps,
        **i2_serve}
    # each kernel's work in one 16-slot tick of FN-SSL (K1) and IPDnet2
    # (K3), fp32
    srow = {r["shape"]: r for r in slot_rows}
    sf, sn = srow["slots16_fullband"], srow["slots16_narrowband"]
    k1_tick = {
        "ms": nf * sf["fused_ms_float32"] + nn_ * sn["ms_float32"],
        "cluster_only_ms": nf * sf["fused_cluster_ms_float32"]
        + nn_ * sn["cluster_ms_float32"],
        "plain_ms": nf * sf["fused_plain_ms"] + nn_ * sn["plain_ms"],
        "library_ms": nf * sf["library_bidir_ms"] + nn_ * sn["library_ms"],
        "library_tf32_ms": nf * sf["library_bidir_ms_tf32"]
        + nn_ * sn["library_ms_tf32"],
        **dict(zip(("bound_ms", "bound_by"), bound(
            {k: 2 * nf * sf["bound_terms_float32"][k]
             + nn_ * sn["bound_terms_float32"][k]
             for k in ("bytes", "operations")}))),
        "routes": [sf["fused_route"], sn["route"]],
        "work": "the recurrences of one 16-slot FN-SSL tick, fp32: 3 "
                "full-band BiLSTMs (T=256, B=192, H=128) and 3 narrow-band "
                "LSTMs (T=12, B=4096, H=256), each on the kernel fwd_route "
                "gives it (routes: full band, narrow band)"}
    for kern in kernels[:2]:
        share = {"lstm_cluster": "cluster", "lstm_wave": "wave"}[kern["name"]]
        parts = [(nf, sf, "fused_", sf["fused_route"], 2),
                 (nn_, sn, "", sn["route"], 1)]
        parts = [p for p in parts if p[3] == share]
        kern["slots16_tick"] = {
            "ms": sum(n * r[f"{pre}ms_float32"] for n, r, pre, _, _ in parts),
            "plain_ms": sum(n * r[f"{pre}plain_ms"]
                            for n, r, pre, _, _ in parts),
            "library_ms": sum(n * r["library_bidir_ms" if d == 2
                                    else "library_ms"]
                              for n, r, _, _, d in parts),
            **dict(zip(("bound_ms", "bound_by"), bound(
                {k: sum(n * d * r["bound_terms_float32"][k]
                        for n, r, _, _, d in parts)
                 for k in ("bytes", "operations")}))),
            "work": "this kernel's launches in one 16-slot FN-SSL tick: "
                    + ", ".join(f"{n} x (T={r['T']}, B={r['B']}, H={r['H']},"
                                f" ndir={d})" for n, r, _, _, d in parts)}
    s3 = {r["shape"]: r for r in ssm_slot_rows}
    slot_bound_ = ssm_path_bound("k3", "slots16_layer0",
                                 "slots16_layers1_7", s3)
    kernels[-2]["slots16_tick"] = {
        "ms": ssm_path("k3_ms_float32", "slots16_layer0",
                       "slots16_layers1_7", s3),
        "plain_ms": ssm_path("k3_plain_ms", "slots16_layer0",
                             "slots16_layers1_7", s3),
        "bound_ms": slot_bound_[0], "bound_by": bound_by(slot_bound_[1]),
        "work": "the scans of one 16-slot IPDnet2 tick: 2 at B=256, L=5, "
                "d=192 and 14 at L=1"}
    kernels[-2]["slots16"] = ssm_slot_rows
    # K3 and K4 over one IPDnet2 train step at mamba(32,4), nb 16, fp32
    d32 = {r["shape"]: r for r in d32_report["scans"]}
    for kern, k in zip(kernels[-2:], ("k3", "k4")):
        b = ssm_path_bound(k, "d32_train_layer0", "d32_train_layers1_7", d32)
        kern["d_state_32_train_step"] = {
            "ms": ssm_path(f"{k}_ms_float32", "d32_train_layer0",
                           "d32_train_layers1_7", d32),
            "plain_ms": ssm_path(f"{k}_plain_ms", "d32_train_layer0",
                                 "d32_train_layers1_7", d32),
            "bound_ms": b[0], "bound_by": bound_by(b[1]),
            "work": "one IPDnet2 train step at attention=mamba(32,4), nb=16 "
                    "x 4 s, fp32: 2 scans at B=256, L=201, d=192, n=32 and "
                    "14 at L=40"}
    kernels.append({
        "name": "lstm_bwd_wide", "route": "cuda",
        "source": "fnssl_tpu_torch/kernels/csrc/lstm_bwd_wide.cu",
        "launches": sum(v["lstm_bwd_wide"] for v in paths.values()),
        "launches_by_path": {k: v["lstm_bwd_wide"] for k, v in paths.items()},
        "max_abs_err": worst_bwd["lstm_bwd_wide"]["float32"],
        "max_abs_err_bf16": worst_bwd["lstm_bwd_wide"]["bfloat16"],
        "checks": bwd_checks["lstm_bwd_wide"],
        **wide_share("k2", "library_bwd_ms"),
        "lstm_backward_ms": 3 * wn["port_bwd_ms"],
        "plan": wn["k2_plan"],
        "bound_share": wn["k2_bound_share_float32"],
        "bound_share_bf16": wn["k2_bound_share_bfloat16"],
        "v2_case": wide_case("k2", "library_bwd_ms"),
        "per_shape": wide_rows,
        # K2's device ms in one traced step of phase 31's cell (this kernel
        # and lstm_bwd_wave.cu's full band)
        "fnssl_h512_step_k2_traced_ms": {
            p: wide_report[p]["k2_device_ms"] for p in ("fp32", "bf16")},
        "fnssl_h512_step_lstm_bwd_wide_traced_ms": {
            p: wide_report[p]["k2_wide_device_ms"] for p in ("fp32", "bf16")}})
    # K1's device ms in one traced step of phase 31's cell (this kernel and
    # lstm_wave.cu's full band)
    kernels[2]["fnssl_h512_step_k1_traced_ms"] = {
        p: wide_report[p]["k1_device_ms"] for p in ("fp32", "bf16")}
    report = {"card": card, "kind": kind, "kernels": kernels,
              "predict": predict_report, "stream": stream_report,
              "serve_slots": slots_report, "export": export_report,
              "train": train, "train_parity": parity, "fit": fit_report,
              "plan_picks": picks, "ipdnet_train": ipd_train,
              "ipdnet_train_parity": ipd_parity, "ipdnet_fit": ipd_fit,
              "ipdnet2_train": i2_train, "ipdnet2_train_parity": i2_parity,
              "ipdnet2_fit": i2_fit, "locata": locata_report,
              "time_modules": time_report, "fit_flags": flags_report,
              "data_parallel": dp_report, "freq_parallel": fp_report,
              "k1_train_step": k1_train_step, "k1_slots16_tick": k1_tick,
              "refused": refused, "fnssl_h512": wide_report,
              "ipdnet2_d32": d32_report, "time_serving": ts_report}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": [{k: v for k, v in kern.items()
                                  if k not in ("plans", "per_shape",
                                               "slots16", "sweep",
                                               "device_ms")}
                                 for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
