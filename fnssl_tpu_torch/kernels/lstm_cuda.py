"""LSTM recurrence: the hand-written Hopper kernels and their plain version.

K1, the forward, replaces ``fnssl_tpu/kernels/lstm_pallas.py:_lstm_kernel``
(launched by ``_lstm_pallas_fwd``). Three CUDA C++ sources for
``sm_90a``, bound with ``ctypes``; ``fwd_route`` chooses one by shape:

- ``csrc/lstm_cluster.cu`` for H a multiple of 32 up to 256 (every LSTM
  of the JAX package), at every shape the rule does not give
  lstm_wave.cu: W_hh stays in a thread-block cluster's shared memory, h
  is exchanged through distributed shared memory, and one launch runs one
  or both directions. ``cluster_plan`` picks its cluster size, batch tile
  and k-split. Built for a step's latency at small B: at large B its
  8-row tiles run in tens of waves.
- ``csrc/lstm_wave.cu`` from ``WAVE_MIN_ROWS`` rows (B times the
  directions) up: tiles of many rows, so that the grid fits in about one
  wave, each step a register-tiled matrix tile with W_hh read from L2 and
  used for every row of the tile; one launch runs one or both directions.
  ``wave_plan`` picks the rows a thread; at H = 128 also a tile of its
  own (128 threads, 37 rows, 2 CTAs an SM: 74 rows on the busiest SM at
  FN-SSL's full band). It takes H 32 to 256 (dividing 256) by name
  (``route="wave"``); the rule gives it only what ``chip_smoke.py``'s
  sweep measured at least 10% faster than lstm_cluster.cu at every T and
  every larger B: at H = 256 from 2048 rows (FN-SSL's narrow band, B = nb
  x 256, from 8 scenes up, in training, in evaluation and in the 16-slot
  tick), at H = 128 from 8192 rows in float32 and 4096 in bfloat16
  (FN-SSL's full band in training, B = nb x 298 in both directions, from
  14 scenes up in float32 and 7 in bfloat16; VariableIPDnet's narrow
  band; IPDnet's in bfloat16).
- ``csrc/lstm_wide.cu`` for H above 256 (up to 1024: FN-SSL at
  hidden_size 512): lstm_wave.cu's one-wave tile widened, a CTA of 256
  threads walking R rows through all T, each thread one unit a pass of
  256 units, h double-buffered in shared memory, W_hh^T read with each
  unit's four gates side by side (``wide_weights``); one launch runs one
  or both directions. ``wide_plan`` picks R (32, 16, 8 or 4) for the
  fewest rows on the busiest SM (route ``"wide"``).

K2, the backward recurrence (H up to 1024), replaces the sequential part
of ``_lstm_backward``, K1's ``custom_vjp``: the replay of c and the
reverse walk that turns the gate pre-activations into dgates, dh0 and dc0
(``lstm_bwd``, ``lstm_bwd_bidir``). Three CUDA C++ sources; ``bwd_route``
chooses one by shape:

- ``csrc/lstm_bwd_cluster.cu`` for H a multiple of 32 up to 256, at every
  shape the rule does not give lstm_bwd_wave.cu: K1's cluster design
  mirrored, each CTA keeping the W_hh columns of its hidden units in
  shared memory and dgates exchanged through distributed shared memory;
  ``bwd_cluster_plan`` picks its plan. Built for a step's latency: at
  large B its 8-row tiles run in tens of waves.
- ``csrc/lstm_bwd_wave.cu`` from ``BWD_WAVE_MIN_ROWS`` rows (B times the
  directions) up: lstm_wave.cu's tile for the backward, a CTA walking many
  rows through the replay and the walk, each step a register-tiled (rows
  x 4H) @ (4H x H) product with W_hh read from L2; the grid fits in about
  one wave. ``bwd_wave_plan`` gives its rows a thread, and at H = 128,
  where the source runs a kernel of its own and no other, a tile of any
  even row count from 10 to 40 (38 at FN-SSL's full band: 76 rows on the
  busiest SM); a bfloat16 W_hh reaches it
  widened to float32. It takes H 32, 64, 128 and 256 by name
  (``route="wave"``); the rule gives it only what ``chip_smoke.py``'s
  sweep measured at least 10% faster than lstm_bwd_cluster.cu at that B
  and every larger one: at H = 256 FN-SSL's narrow band from 8 scenes up
  in float32, from 16 in bfloat16; at H = 128 from 4768 rows in float32
  (FN-SSL's full band in training and in a DP rank's step), 8192 in
  bfloat16 (the full band in training), and VariableIPDnet's narrow band.
- ``csrc/lstm_bwd_wide.cu`` for H above 256 (up to 1024: FN-SSL at
  hidden_size 512): lstm_bwd_wave.cu's tile widened, one or two columns of
  32 units a lane, 4 x R rows a CTA, one CTA an SM; ``bwd_wide_plan``
  gives R.

An LSTM whose H is not a multiple of 32 runs on the card padded to the
next multiple (``padded_hidden``; ``lstm_fwd_padded``, ``lstm_bwd_padded``):
zero rows and columns in each gate block of W_hh and zeros in xg (or G),
h0, c0, dys, dhT and dcT. A padded unit has i = f = o = 1/2 and g = 0, so
it stays 0 and reads nothing into the real units; its gradients are 0.
Above H = 1024 the card raises.

Each source's header comment says what bounds it on the card and how the
design responds. Every wrapper runs the plain version for tensors on the
CPU and launches a kernel for CUDA tensors; it never swaps one for the
other, and a kernel that fails to build or launch raises. Gradients go
through ``models.lstm``, whose ``torch.autograd.Function`` runs K1
forward and K2 backward; a direct call of ``lstm_fwd`` on CUDA inputs
that require grad, with grad enabled, is refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from fnssl_tpu_torch.kernels.cuda_build import LaunchCounter, load_library

# launches of each CUDA kernel (the plain version is not counted):
# ``launches`` for lstm_cluster.cu, ``launches_wave`` for lstm_wave.cu,
# ``launches_wide`` for lstm_wide.cu, ``launches_bwd_cluster`` for
# lstm_bwd_cluster.cu, ``launches_bwd_wave`` for lstm_bwd_wave.cu,
# ``launches_bwd_wide`` for lstm_bwd_wide.cu
launches = LaunchCounter()
launches_wave = LaunchCounter()
launches_wide = LaunchCounter()
launches_bwd_cluster = LaunchCounter()
launches_bwd_wave = LaunchCounter()
launches_bwd_wide = LaunchCounter()

_DTYPES = (torch.float32, torch.bfloat16)

CLUSTER_MAX_HIDDEN = 256          # lstm_cluster.cu's H; lstm_wide.cu above
MAX_HIDDEN = 1024                 # K1's H (lstm_wide.cu's)
BWD_MAX_HIDDEN = 1024             # K2's H (lstm_bwd_wide.cu's above 256)
BWD_MAX_THREADS = 512             # threads of a lstm_bwd_cluster.cu CTA
BWD_UPTS = (2, 1)                 # units a thread sums in its product
BWD_TILE = 8                      # batch rows of a lstm_bwd_cluster.cu tile
# dynamic shared memory a CTA may use: 227 KB less 16 B of mbarriers
SMEM_BYTES = 232_448 - 16
# an H100 SM's shared memory (228 KB), of which the runtime reserves 1 KB
# for each resident CTA
SM_SMEM_BYTES = 233_472
CTA_RESERVED_SMEM = 1_024
MAX_THREADS = {8: 512, 16: 256}   # threads a CTA may have, by tile
CLUSTER_SIZES = (1, 2, 4, 8)      # 8 is the portable cluster limit
SMS = 132                         # an H100 SXM's SMs
TILES = (8, 16)                   # lstm_cluster.cu's tiles
WAVE_THREADS = 256                # threads of a lstm_wave.cu CTA
WAVE_ROWS = (32, 16, 8)           # rows a thread lstm_wave.cu is built for
WAVE_PAD = 4                      # floats a row of its h is padded by
# lstm_wave.cu's H = 128 tile: a CTA of 128 threads (one row group) of 37
# rows, 2 CTAs an SM (FN-SSL's full band, 2 x 4768 rows, in 258 tiles: 74
# rows an SM). A 24-row tile, 3 CTAs an SM, measured no faster in float32
# and 30% slower in bfloat16 than 16 rows a thread at 12288 rows (PERF.md)
WAVE128_ROWS = (37,)
WAVE128_THREADS = 128
# fwd_route's rule: lstm_wave.cu from this many rows (B x directions) up,
# by (H, itemsize); H absent: never. Set from chip_smoke.py's sweep
# (PERF.md): the fewest rows from which lstm_wave.cu measured at least 10%
# faster than lstm_cluster.cu at every T of the sweep (12 and 298; 280 at
# 12288 rows) and every larger B (at H = 256, 1024 rows, T = 298: 7% in
# fp32, 13% in bf16; at H = 128 in fp32, 4768 rows at T = 298: 9%)
WAVE_MIN_ROWS = {(256, 4): 2048, (256, 2): 2048, (128, 4): 8192,
                 (128, 2): 4096}
# lstm_wide.cu (H 288 to 1024): a CTA of 256 threads, one unit a thread in
# each pass of 256 units, owns a tile of R rows; R by its registers and its
# shared memory, CTAs an SM as the registers are budgeted (1, 2, 3, 3)
WIDE_THREADS = 256
WIDE_ROWS = (32, 16, 8, 4)
BWD_WAVE_THREADS = 256            # threads of a lstm_bwd_wave.cu CTA
BWD_WAVE_UNITS = 4                # hidden units a thread of it owns
BWD_WAVE_ROWS = (4, 5)            # rows a thread of it at H 32, 64 and 256
BWD_WAVE_PAD = 4                  # floats a row of its dgates is padded by
# lstm_bwd_wave.cu's H = 128 tiles, its only plans at that width: any even
# row count from 10 to 40 a CTA (8 row groups of R = ceil(tile / 8) rows,
# the last slot in the first (tile - 8 (R - 1)) / 2 warp-rows), 2 CTAs an SM
BWD_WAVE128_TILES = tuple(range(10, 41, 2))
BWD_WAVE128_GROUPS = 8
# a wave of its grid measured 1.8 + R units of time, R = ceil(tile / 8)
# rows a thread (tools/lstm_h128_variants.py: 8.3, 19.8 and 13.1 ms at R 2,
# 3 and 5 in 1, 2 and 1 waves at T 280, 280 and 256; PERF.md)
BWD_WAVE128_FIXED = 1.8
# bwd_route's rule: lstm_bwd_wave.cu from this many rows (B x directions)
# up, by (H, itemsize); H absent: never. Set from chip_smoke.py's sweep
# (PERF.md): the fewest rows from which lstm_bwd_wave.cu measured at least
# 10% faster than lstm_bwd_cluster.cu at T = 298 (280 at 12288 rows) at
# every point of as many rows or more (at H = 128, 4096 rows: 2% in fp32,
# slower in bf16)
BWD_WAVE_MIN_ROWS = {(256, 4): 2048, (256, 2): 4096, (128, 4): 4768,
                     (128, 2): 8192}
# lstm_bwd_wide.cu (H 288 to 1024): a warp is 8 unit lanes x 4 row groups,
# a lane owns 4 units of one column of 32 (two columns above H = 512), and
# a CTA of up to 512 threads owns tiles of 4 x R rows, R by the columns
BWD_WIDE_GROUPS = 4
BWD_WIDE_ROWS = {1: (4, 2, 1), 2: (2, 1)}
BWD_WIDE_MAX_THREADS = 512


def lstm_fwd_plain(xg: torch.Tensor, w_hh_t: torch.Tensor,
                   h0: torch.Tensor, c0: torch.Tensor, *,
                   reverse: bool = False):
    """Step loop with a float32 recurrence, like ``_scan_reference``.

    xg (T, B, 4H) float32/bfloat16; w_hh_t (H, 4H) in xg's dtype;
    h0, c0 (B, H) float32. Returns ys (T, B, H) in xg's dtype and hT, cT
    (B, H) float32.
    """
    t_steps = xg.shape[0]
    w = w_hh_t.float()
    h, c = h0.float(), c0.float()
    ys = xg.new_empty(xg.shape[:2] + (w.shape[0],))
    order = range(t_steps - 1, -1, -1) if reverse else range(t_steps)
    for t in order:
        gates = xg[t].float() + h @ w
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[t] = h.to(ys.dtype)
    return ys, h, c


def lstm_fwd_bidir_plain(xg: torch.Tensor, w_hh_t: torch.Tensor,
                         h0: torch.Tensor, c0: torch.Tensor):
    """Both directions of a BiLSTM: ``lstm_fwd_plain`` forward on [0] and
    backward on [1], each over the unflipped xg. Shapes as
    ``lstm_fwd_bidir``."""
    fwd = lstm_fwd_plain(xg[0], w_hh_t[0], h0[0], c0[0])
    bwd = lstm_fwd_plain(xg[1], w_hh_t[1], h0[1], c0[1], reverse=True)
    return tuple(torch.stack(pair) for pair in zip(fwd, bwd))


def cluster_smem(hidden: int, itemsize: int, n: int, bt: int,
                 ks: int) -> int:
    """Shared memory (bytes) of one CTA of lstm_cluster.cu: the W_hh slice
    (H x 4H/N in xg's dtype), two h buffers (Bt x H float32) and the KS x 4
    partial gate sums (Bt x H/N float32)."""
    units = hidden // n
    return (hidden * 4 * units * itemsize + 2 * bt * hidden * 4
            + ks * 4 * bt * units * 4)


def _k_splits(hidden: int, itemsize: int, n: int, bt: int):
    """The k-splits lstm_cluster.cu takes for (N, Bt): KS = H/16, then H/8
    (each thread sums a k-slice of 16 or 8, a compile-time length)."""
    units = hidden // n
    for ks in (hidden // 16, hidden // 8):
        if (ks * units <= MAX_THREADS[bt] and 2 * ks >= bt
                and cluster_smem(hidden, itemsize, n, bt, ks) <= SMEM_BYTES):
            yield ks


@functools.lru_cache(maxsize=None)
def cluster_plan(hidden: int, itemsize: int, batch: int, ndir: int = 1, *,
                 n: int | None = None, bt: int | None = None,
                 ks: int | None = None):
    """(N, Bt, KS) for lstm_cluster.cu: CTAs per cluster, batch rows per
    tile and the k-split inside a CTA.

    By default 8 rows a tile, and the cluster size by the grid's tiles
    (B/8 a direction, ``ndir`` directions): while the tiles are no more
    than the card's SMs (serving: B = 12 or 256), the largest cluster that
    keeps 16 hidden units a CTA (N = 8 at H >= 128, 4 at H = 64), which
    spreads each tile's step over the most SMs; above (training, B in the
    thousands) the smallest cluster from N = 2 that fits, since every SM
    then holds tiles already and a larger cluster only adds exchanges and
    waves. The k-split is H/16 (a k-slice of 16), or H/8 where H/16 leaves
    the CTA fewer than 128 threads. Measured on the card (PERF.md): the
    fastest plan at every serve shape of FN-SSL and IPDnet, and within 3%
    of the fastest at every training shape (N = 8 had been 64-80% slower
    at IPDnet's H = 64 training shapes and 41% at its serve full band).
    ``n``, ``bt`` and ``ks`` pin any of the three, to time other plans. A
    plan fits when the CTA has <= 512 threads (256 at 16 rows a tile),
    each thread finishes at most 2 rows in the cell update, and the CTA's
    shared memory stays within 227 KB.
    """
    if hidden % 32 or not 32 <= hidden <= CLUSTER_MAX_HIDDEN:
        raise ValueError(f"lstm_cluster: hidden={hidden} must be a multiple "
                         f"of 32 up to {CLUSTER_MAX_HIDDEN}")
    tiles = -(-batch // TILES[0]) * ndir
    if n:
        ns = (n,)
    elif tiles <= SMS:
        ns = sorted(CLUSTER_SIZES, key=lambda m: (hidden // m < 16, -m))
    else:
        ns = CLUSTER_SIZES[1:] + CLUSTER_SIZES[:1]
    bts = (bt,) if bt else TILES
    for b in bts:
        for m in ns:
            if m not in CLUSTER_SIZES or b not in TILES:
                raise ValueError(f"lstm_cluster: no plan with N={m}, Bt={b}")
            splits = list(_k_splits(hidden, itemsize, m, b))
            if len(splits) == 2 and splits[0] * (hidden // m) < 128:
                splits.reverse()
            for k in splits:
                if ks in (None, k):
                    return m, b, k
    raise ValueError(f"lstm_cluster: no plan fits hidden={hidden}, "
                     f"itemsize={itemsize}, N={n}, Bt={bt}, KS={ks}")


def wave_tile(hidden: int, rows: int) -> int:
    """Batch rows of a lstm_wave.cu tile: each of its 256 threads owns one
    hidden unit of ``rows`` rows; at H = 128 a plan of ``WAVE128_ROWS`` is
    a CTA of 128 threads, one row group of that many rows."""
    if hidden == 128 and rows in WAVE128_ROWS:
        return rows
    return WAVE_THREADS // hidden * rows


def wave_smem(hidden: int, itemsize: int, tile: int) -> int:
    """Shared memory (bytes) of one CTA of lstm_wave.cu with a tile of
    ``tile`` rows: h (H x (tile + 4) float32), c (tile x H float32) and one
    step's xg (tile x 4H in xg's dtype)."""
    return (hidden * (tile + WAVE_PAD) * 4 + tile * hidden * 4
            + tile * 4 * hidden * itemsize)


def wave128_smem(rows: int) -> int:
    """Shared memory (bytes) of one CTA of lstm_wave.cu's H = 128 tile of
    ``rows`` rows: two h buffers (128 x (rows rounded up to 4, + 4)) and c
    (rows x 128), float32; its xg goes straight to registers."""
    pitch = -(-rows // 4) * 4 + WAVE_PAD
    return (2 * 128 * pitch + rows * 128) * 4


def wave_ctas_per_sm(hidden: int, itemsize: int, rows: int) -> int:
    """CTAs of lstm_wave.cu an SM holds at ``rows`` rows a thread: as its
    registers are budgeted (``__launch_bounds__`` for the 4 x rows
    accumulators: 3 at 8 rows, 2 at 16, 1 at 32; 2 of H = 128's
    128-thread tile), or fewer where the shared memory does not take
    them."""
    if hidden == 128 and rows in WAVE128_ROWS:
        return min(2, _ctas_per_sm(wave128_smem(rows), 0))
    regs = 3 if rows <= 8 else 2 if rows <= 16 else 1
    return min(regs, _ctas_per_sm(wave_smem(hidden, itemsize,
                                            wave_tile(hidden, rows))))


def wave_fits(hidden: int, itemsize: int, rows: int) -> bool:
    """Whether lstm_wave.cu takes ``rows`` rows a thread at this H: rows it
    is built for, H a multiple of 32 that divides 256 (the row groups of a
    CTA: 32, 64, 128 or 256), and the CTA's shared memory within 227 KB;
    at H = 128 also ``WAVE128_ROWS``."""
    if hidden == 128 and rows in WAVE128_ROWS:
        return wave128_smem(rows) <= SMEM_BYTES
    return (rows in WAVE_ROWS and 32 <= hidden <= WAVE_THREADS
            and WAVE_THREADS % hidden == 0
            and wave_smem(hidden, itemsize, wave_tile(hidden, rows))
            <= SMEM_BYTES)


def _fewest_busiest(plans, batch, ndir, tile, per_sm):
    """Of ``plans``, the one whose grid (ndir x ceil(B / tile) CTAs) puts
    the fewest rows on the busiest SM; on a tie the first."""
    best = None
    for plan in plans:
        rows = tile(plan)
        busiest = _busiest(rows, -(-batch // rows) * ndir, per_sm(plan))
        if best is None or busiest < best[0]:
            best = (busiest, plan)
    return None if best is None else best[1]


@functools.lru_cache(maxsize=None)
def wave_plan(hidden: int, itemsize: int, batch: int, ndir: int = 1) -> int:
    """Rows a thread of lstm_wave.cu (its tile is rows x 256/H batch rows;
    at H = 128 also ``WAVE128_ROWS``' tiles of that many rows).

    Of the plans that fit, the one whose grid (ndir x ceil(B / tile) CTAs)
    puts the fewest rows on the busiest SM, counting each wave of the grid
    (``wave_ctas_per_sm`` CTAs an SM) in turn; on a tie, the H = 128 tile,
    then the most rows a thread (fewer CTAs, each reading W_hh once a
    step).
    At H = 256: B = 4096 is 128 CTAs of 32 rows, one wave; B = 2048, 128
    of 16 (measured 9.50 ms at T = 298 against 15.41 for 64 CTAs of 32;
    PERF.md). At H = 128, FN-SSL's full band (B = 4768, both directions)
    is 258 tiles of 37 rows, 2 an SM: 74 rows on the busiest SM, where the
    256-thread tiles put 80 to 128.
    """
    plans = [r for r in WAVE128_ROWS + WAVE_ROWS
             if wave_fits(hidden, itemsize, r)]
    best = _fewest_busiest(plans, batch, ndir,
                           lambda r: wave_tile(hidden, r),
                           lambda r: wave_ctas_per_sm(hidden, itemsize, r))
    if best is None:
        raise ValueError(f"lstm_wave: no plan fits hidden={hidden}, "
                         f"itemsize={itemsize}")
    return best


def wide_smem(hidden: int, rows: int) -> int:
    """Shared memory (bytes) of one CTA of lstm_wide.cu with a tile of
    ``rows`` rows: two h buffers (H x (rows + 4)) and c (rows x H),
    float32; its xg goes straight to registers."""
    return (2 * hidden * (rows + WAVE_PAD) + rows * hidden) * 4


def wide_ctas_per_sm(hidden: int, rows: int) -> int:
    """CTAs of lstm_wide.cu an SM holds at ``rows`` rows: as its registers
    are budgeted (``__launch_bounds__`` for the 4 x rows accumulators: 1 at
    32 rows, 2 at 16, 3 at 8 and 4), or fewer where the shared memory does
    not take them."""
    regs = 3 if rows <= 8 else 2 if rows <= 16 else 1
    return min(regs, _ctas_per_sm(wide_smem(hidden, rows), 0))


def wide_fits(hidden: int, rows: int) -> bool:
    """Whether lstm_wide.cu takes a tile of ``rows`` rows at this H: H a
    multiple of 32 above 256 up to 1024, rows it is built for, and the
    CTA's shared memory within 227 KB (32 rows up to H = 544, 16 up to
    1024)."""
    return (CLUSTER_MAX_HIDDEN < hidden <= MAX_HIDDEN and hidden % 32 == 0
            and rows in WIDE_ROWS
            and wide_smem(hidden, rows) <= SMEM_BYTES)


@functools.lru_cache(maxsize=None)
def wide_plan(hidden: int, batch: int, ndir: int = 1) -> int:
    """Rows of a lstm_wide.cu tile: of the plans that fit, the one whose
    grid (ndir x ceil(B / rows) CTAs, ``wide_ctas_per_sm`` an SM) puts the
    fewest rows on the busiest SM, counting each wave in turn; on a tie
    the most rows (fewer CTAs, each W_hh value read feeding more rows). At
    (298, 4096, 512): 32 rows, 128 CTAs in one wave (31.03 rows an SM if
    spread evenly); at H 768 and 1024, B 4096: 16 rows, 256 CTAs, 32 rows
    on the busiest SM; at B = 13: 4 rows, 4 CTAs."""
    plans = [r for r in WIDE_ROWS if wide_fits(hidden, r)]
    best = _fewest_busiest(plans, batch, ndir, lambda r: r,
                           lambda r: wide_ctas_per_sm(hidden, r))
    if best is None:
        raise ValueError(f"lstm_wide: no plan fits hidden={hidden}")
    return best


def fwd_route(t_steps: int, batch: int, hidden: int, ndir: int,
              itemsize: int) -> str:
    """K1's kernel for a shape, by shape alone: "wide" (lstm_wide.cu)
    above H = 256; "wave" (lstm_wave.cu) from ``WAVE_MIN_ROWS[(H,
    itemsize)]`` rows (B x ndir) up; else "cluster" (lstm_cluster.cu). The
    thresholds come from chip_smoke.py's sweep over T in {12, 298}, B in
    {256 .. 4768}, H in {128, 256}, both directions and both dtypes;
    ``t_steps`` does not move them (both T of the sweep cross at the same
    B)."""
    del t_steps
    if hidden > CLUSTER_MAX_HIDDEN:
        return "wide"
    least = WAVE_MIN_ROWS.get((hidden, itemsize))
    if least is not None and batch * ndir >= least:
        return "wave"
    return "cluster"


def bwd_wave_tile(hidden: int, plan: int) -> int:
    """Batch rows of a lstm_bwd_wave.cu tile of ``plan``: at H 32, 64 and
    256 its 256 threads own 4 hidden units each, so 1024/H row groups of
    ``plan`` rows a thread; at H = 128 the plan is the tile's rows
    (``BWD_WAVE128_TILES``)."""
    if hidden == 128:
        return plan
    return BWD_WAVE_THREADS * BWD_WAVE_UNITS // hidden * plan


def bwd_wave_smem(hidden: int, itemsize: int, tile: int) -> int:
    """Shared memory (bytes) of one CTA of lstm_bwd_wave.cu with a tile of
    ``tile`` rows: dgates, which also take the step's G (tile x (4H + 4)
    float32), c_{t-1} (tile x H float32) and dy_t (tile x H in ys's
    dtype)."""
    return (tile * (4 * hidden + BWD_WAVE_PAD) * 4 + tile * hidden * 4
            + tile * hidden * itemsize)


def bwd_wave128_smem(tile: int) -> int:
    """Shared memory (bytes) of one CTA of lstm_bwd_wave.cu's H = 128 tile:
    dgates alone (tile x (4H + 4) float32); G, c_{t-1} and dy_t go
    straight to registers."""
    return tile * (4 * 128 + BWD_WAVE_PAD) * 4


def bwd_wave_ctas_per_sm(hidden: int, itemsize: int, plan: int) -> int:
    """CTAs of lstm_bwd_wave.cu an SM holds at ``plan``: two, as its
    registers are budgeted (``__launch_bounds__(256, 2)``), or fewer where
    the shared memory does not take them."""
    if hidden == 128:
        return min(2, _ctas_per_sm(bwd_wave128_smem(plan), 0))
    return min(2, _ctas_per_sm(bwd_wave_smem(
        hidden, itemsize, bwd_wave_tile(hidden, plan))))


def bwd_wave_fits(hidden: int, itemsize: int, plan: int) -> bool:
    """Whether lstm_bwd_wave.cu takes ``plan`` at this H: at H 32, 64 and
    256 rows a thread it is built for (a warp's 8 lanes of 4 units, 1024/H
    row groups) with two CTAs' shared memory on an SM (5 rows: a bfloat16
    dy only, as the source is built); at H = 128 a tile of
    ``BWD_WAVE128_TILES``, in either dtype."""
    if hidden == 128:
        return (plan in BWD_WAVE128_TILES
                and bwd_wave_ctas_per_sm(hidden, itemsize, plan) >= 2)
    return (plan in BWD_WAVE_ROWS and (plan == 4 or itemsize == 2)
            and 32 <= hidden <= CLUSTER_MAX_HIDDEN and hidden % 32 == 0
            and BWD_WAVE_THREADS * BWD_WAVE_UNITS % hidden == 0
            and _ctas_per_sm(bwd_wave_smem(
                hidden, itemsize, bwd_wave_tile(hidden, plan))) >= 2)


def bwd_wave_plans(hidden: int, itemsize: int) -> tuple[int, ...]:
    """Every plan lstm_bwd_wave.cu takes at this H and dtype."""
    return tuple(p for p in BWD_WAVE_ROWS + BWD_WAVE128_TILES
                 if bwd_wave_fits(hidden, itemsize, p))


def _busiest(tile: int, ctas: int, per_sm: int) -> int:
    """Rows on the busiest SM of a grid of ``ctas`` tiles of ``tile`` rows
    at ``per_sm`` CTAs an SM, counting each wave of the grid in turn."""
    slots = SMS * per_sm
    full, rest = divmod(ctas, slots)
    return (full * slots // SMS + -(-rest // SMS)) * tile


def _bwd_wave128_cost(tile: int, batch: int, ndir: int):
    """(the waves of the grid x (1.8 + R), rows on the busiest SM) of
    lstm_bwd_wave.cu's H = 128 tile of `tile` rows, two CTAs an SM."""
    ctas = -(-batch // tile) * ndir
    rows = -(-tile // BWD_WAVE128_GROUPS)
    return (-(-ctas // (2 * SMS)) * (BWD_WAVE128_FIXED + rows),
            _busiest(tile, ctas, 2))


@functools.lru_cache(maxsize=None)
def bwd_wave_plan(hidden: int, itemsize: int, batch: int,
                  ndir: int = 1) -> int:
    """Rows a thread of lstm_bwd_wave.cu (its tile is rows x 1024/H batch
    rows), or at H = 128 a tile of 10 to 40 rows, its only layout there.

    At H 32, 64 and 256, chosen as ``wave_plan`` chooses lstm_wave.cu's: of
    the rows that fit, the one whose grid (ndir x ceil(B / tile) CTAs)
    puts the fewest rows on the busiest SM; on a tie, 4 rows. At H = 256,
    B = 4096 is 256 CTAs of 16 rows, two an SM, in one wave; with a
    bfloat16 dy, B = 4768 is 239 CTAs of 20 rows in one wave (against 298
    of 16 in two). 8 rows (one CTA an SM) and 2 (three) were built and
    measured slower at every B from 2048 to 4768 (PERF.md), and 5 rows at
    B = 4768 in both directions, where it ties on rows.

    At H = 128, the tile whose grid costs the least as measured: its waves
    (two CTAs an SM) times 1.8 + R, R = ceil(tile / 8) rows a thread,
    whatever the rows of a partial last wave (a CTA's time follows its
    rows a thread more than the CTAs beside it); on a tie, the fewest rows
    on the busiest SM. FN-SSL's full band (B = 4768, both directions) is
    252 tiles of 38 rows in one wave: 76 rows on the busiest SM, against
    96 for 32-row tiles in two; IPDnet's narrow band (B = 4096) 256 tiles
    of 16; VariableIPDnet's (12288) 512 tiles of 24 in two waves (19.8 ms
    at T = 280, against 25.7 for 384 tiles of 32 and 30.4 for 1024 of 12).
    """
    if hidden == 128:
        return min(BWD_WAVE128_TILES,
                   key=lambda t: _bwd_wave128_cost(t, batch, ndir))
    best = _fewest_busiest(bwd_wave_plans(hidden, itemsize), batch, ndir,
                           lambda p: bwd_wave_tile(hidden, p),
                           lambda p: bwd_wave_ctas_per_sm(hidden, itemsize,
                                                          p))
    if best is None:
        raise ValueError(f"lstm_bwd_wave: no plan fits hidden={hidden}, "
                         f"itemsize={itemsize}")
    return best


def bwd_wide_columns(hidden: int) -> int:
    """Columns of 32 units a lane of lstm_bwd_wide.cu owns: 1 up to H =
    512, 2 above (a CTA of up to 16 warps covers H / 32 columns)."""
    return 1 if hidden // 32 <= 16 else 2


def bwd_wide_threads(hidden: int) -> int:
    """Threads of a lstm_bwd_wide.cu CTA: a warp for each J columns."""
    return 32 * -(-(hidden // 32) // bwd_wide_columns(hidden))


def bwd_wide_tile(plan: int) -> int:
    """Batch rows of a lstm_bwd_wide.cu tile of ``plan`` rows a thread."""
    return BWD_WIDE_GROUPS * plan


def bwd_wide_smem(hidden: int, tile: int) -> int:
    """Shared memory (bytes) of one CTA of lstm_bwd_wide.cu: dgates (tile x
    (4H + 4) float32) and dc (tile x (H + 4) float32); G, c and dy go
    straight to registers."""
    return tile * (4 * hidden + BWD_WAVE_PAD + hidden + BWD_WAVE_PAD) * 4


def bwd_wide_fits(hidden: int, plan: int) -> bool:
    """Whether lstm_bwd_wide.cu takes ``plan`` rows a thread at this H: H a
    multiple of 32 above 256 up to 1024, rows it is built for at this many
    columns a lane, at most 512 threads and 227 KB of shared memory."""
    return (CLUSTER_MAX_HIDDEN < hidden <= BWD_MAX_HIDDEN
            and hidden % 32 == 0
            and plan in BWD_WIDE_ROWS[bwd_wide_columns(hidden)]
            and bwd_wide_threads(hidden) <= BWD_WIDE_MAX_THREADS
            and bwd_wide_smem(hidden, bwd_wide_tile(plan)) <= SMEM_BYTES)


def bwd_wide_plans(hidden: int) -> tuple[int, ...]:
    """Every plan lstm_bwd_wide.cu takes at this H, the most rows first."""
    return tuple(p for p in BWD_WIDE_ROWS[bwd_wide_columns(hidden)]
                 if bwd_wide_fits(hidden, p))


@functools.lru_cache(maxsize=None)
def bwd_wide_plan(hidden: int, batch: int, ndir: int = 1) -> int:
    """Rows a thread of lstm_bwd_wide.cu (tiles of 4 x that many rows): of
    the plans that fit, the one whose grid (ndir x ceil(B / tile) CTAs, one
    an SM) puts the fewest rows on the busiest SM, counting each wave in
    turn; on a tie the most rows a thread (fewer CTAs, each reading W_hh
    once a step for more rows). At (298, 4096, 512): 4 rows, 256 tiles of
    16 in two waves, 32 rows on the busiest SM (31.03 spread evenly); at H
    = 1024 and B = 4096: 2 rows, 512 tiles of 8, 32 rows."""
    best = _fewest_busiest(bwd_wide_plans(hidden), batch, ndir,
                           bwd_wide_tile, lambda p: 1)
    if best is None:
        raise ValueError(f"lstm_bwd_wide: no plan fits hidden={hidden}")
    return best


def bwd_route(t_steps: int, batch: int, hidden: int, ndir: int,
              itemsize: int) -> str:
    """K2's kernel for a shape, by shape alone: "wide" (lstm_bwd_wide.cu)
    above H = 256; "wave" (lstm_bwd_wave.cu) from
    ``BWD_WAVE_MIN_ROWS[(H, itemsize)]`` rows (B x ndir) up; else "cluster"
    (lstm_bwd_cluster.cu). The thresholds come from chip_smoke.py's sweep
    over B in {1024 .. 4768}, H in {128, 256}, both directions and both
    dtypes at T = 298; ``t_steps`` does not move them."""
    del t_steps
    if hidden > CLUSTER_MAX_HIDDEN:
        return "wide"
    least = BWD_WAVE_MIN_ROWS.get((hidden, itemsize))
    if least is not None and batch * ndir >= least:
        return "wave"
    return "cluster"


def bwd_cluster_smem(hidden: int, itemsize: int, n: int, bt: int,
                     ks: int) -> int:
    """Shared memory (bytes) of one CTA of lstm_bwd_cluster.cu: the W_hh
    column slice (4H x H/N in ys's dtype), two dgates buffers (Bt x 4H
    float32) and the KS partial dh sums (Bt x H/N float32)."""
    units = hidden // n
    return (4 * hidden * units * itemsize + 2 * bt * 4 * hidden * 4
            + ks * bt * units * 4)


def bwd_cluster_fits(hidden: int, itemsize: int, n: int, bt: int, ks: int,
                     upt: int) -> bool:
    """Whether lstm_bwd_cluster.cu takes (N, Bt, KS, UPT) at this H: tiles
    of 8 rows, a k-slice of H/KS = 16 or 8 units, UPT dividing the CTA's
    H/N units, KS x H/N / UPT <= 512 threads and at most 2 (row, unit)
    pairs a thread in the cell part, and the shared memory within 227 KB."""
    units = hidden // n
    return (n in CLUSTER_SIZES and bt == BWD_TILE and upt in BWD_UPTS
            and ks in (hidden // 16, hidden // 8) and units % upt == 0
            and ks * units // upt <= BWD_MAX_THREADS and upt * bt <= 2 * ks
            and bwd_cluster_smem(hidden, itemsize, n, bt, ks) <= SMEM_BYTES)


def _ctas_per_sm(smem: int, static: int = 16) -> int:
    """CTAs of `smem` dynamic bytes (and `static` of mbarriers) that share
    one SM's shared memory."""
    return SM_SMEM_BYTES // (smem + static + CTA_RESERVED_SMEM)


@functools.lru_cache(maxsize=None)
def bwd_cluster_plan(hidden: int, itemsize: int):
    """(N, Bt, KS, UPT) for lstm_bwd_cluster.cu: CTAs per cluster, batch
    rows per tile (8), the k-split inside a CTA and the units a thread sums
    in the product.

    The first that fits in this order: UPT = 2, then 1; the smallest
    cluster from N = 1 up, a cluster of 1 (no exchange) only at UPT = 2 and
    with two of its CTAs on an SM; and of its k-splits the one that puts
    the most CTAs on an SM, KS = H/8 (the more threads) on a tie. A thread
    that sums two units halves the product's dgates loads from shared
    memory, which set its pace; a smaller cluster puts fewer SMs on a tile,
    so that more tiles run at once, in fewer waves of the grid; and two
    CTAs on an SM hide each other's waits (N = 1 with one CTA an SM, at
    H=128 in bfloat16, measured slower than N = 2 with two). At FN-SSL's
    training shapes the rule gives (2, 8, 16, 2) at H=128 and (8, 8, 32, 2)
    at H=256 in float32, (2, 8, 8, 2) and (4, 8, 16, 2) in bfloat16; at
    IPDnet's H=64, (1, 8, 8, 2): the fastest of every plan that fits at
    each shape but one, within 3% of it there (chip_smoke.py phases 9 and
    12; PERF.md). The wrappers' ``plan`` takes any other plan that
    ``bwd_cluster_fits``.
    """
    if hidden % 32 or not 32 <= hidden <= CLUSTER_MAX_HIDDEN:
        raise ValueError(f"lstm_bwd_cluster: hidden={hidden} must be a "
                         f"multiple of 32 up to {CLUSTER_MAX_HIDDEN}")
    for upt in BWD_UPTS:
        for n in CLUSTER_SIZES:
            splits = [ks for ks in (hidden // 8, hidden // 16)
                      if bwd_cluster_fits(hidden, itemsize, n, BWD_TILE, ks,
                                          upt)]
            if n == 1:
                splits = [ks for ks in splits if upt == 2 and _ctas_per_sm(
                    bwd_cluster_smem(hidden, itemsize, 1, BWD_TILE, ks)) >= 2]
            if splits:
                ks = max(splits, key=lambda k: _ctas_per_sm(bwd_cluster_smem(
                    hidden, itemsize, n, BWD_TILE, k)))
                return n, BWD_TILE, ks, upt
    raise ValueError(f"lstm_bwd_cluster: no plan fits hidden={hidden}, "
                     f"itemsize={itemsize}")


def _check(xg, w_hh_t, h0, c0, ndir: int | None = None):
    lead = () if ndir is None else (ndir,)
    nd = len(lead)
    if xg.dim() != 3 + nd or xg.shape[-1] % 4 or tuple(xg.shape[:nd]) != lead:
        want = "(2, T, B, 4H)" if nd else "(T, B, 4H)"
        raise ValueError(f"xg must be {want}, got {tuple(xg.shape)}")
    t_steps, batch, four_h = xg.shape[nd:]
    hidden = four_h // 4
    if xg.dtype not in _DTYPES:
        raise TypeError(f"xg must be float32 or bfloat16, got {xg.dtype}")
    if w_hh_t.dtype != xg.dtype:
        raise TypeError(f"w_hh_t must have xg's dtype {xg.dtype}, got "
                        f"{w_hh_t.dtype}")
    if tuple(w_hh_t.shape) != lead + (hidden, four_h):
        raise ValueError(f"w_hh_t must be {lead + (hidden, four_h)}, got "
                         f"{tuple(w_hh_t.shape)}")
    for name, s in (("h0", h0), ("c0", c0)):
        if s.dtype != torch.float32 or tuple(s.shape) != lead + (batch,
                                                                  hidden):
            raise ValueError(f"{name} must be float32 {lead + (batch, hidden)}"
                             f", got {s.dtype} {tuple(s.shape)}")
    tensors = (xg, w_hh_t, h0, c0)
    if not xg.is_cuda:
        if any(t.is_cuda for t in tensors):
            raise ValueError("lstm_fwd: inputs on mixed devices")
        return None
    if any(t.device != xg.device for t in tensors):
        raise ValueError("lstm_fwd: inputs on mixed devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("lstm_fwd: no backward through a direct call; "
                           "take gradients through models.lstm (its "
                           "autograd Function runs the backward kernel)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lstm_fwd: inputs must be contiguous")
    if hidden > MAX_HIDDEN:
        raise ValueError(f"lstm_fwd: hidden={hidden}: the CUDA forward "
                         f"takes H up to {MAX_HIDDEN}")
    return t_steps, batch, hidden


def lstm_fwd(xg: torch.Tensor, w_hh_t: torch.Tensor, h0: torch.Tensor,
             c0: torch.Tensor, *, reverse: bool = False, plan=None,
             route: str | None = None):
    """One LSTM direction over T steps (contract of ``lstm_fwd_plain``).

    CPU tensors take the plain version. CUDA tensors launch one kernel,
    chosen by shape (``fwd_route``): lstm_cluster.cu or lstm_wave.cu for
    H up to 256, lstm_wide.cu for H above 256 up to 1024. ``route``
    ("cluster" or "wave" up to H = 256, "wide" above) names the kernel
    instead, to hold or time one at any shape; ``plan`` overrides
    the route's plan (``cluster_plan``'s (N, Bt, KS), ``wave_plan``'s rows
    a thread, ``wide_plan``'s rows). Any B; H up to 1024, run padded to a
    multiple of 32 (``lstm_fwd_padded``) where it is not one.
    """
    dims = _check(xg, w_hh_t, h0, c0)
    if dims is None:
        return lstm_fwd_plain(xg, w_hh_t, h0, c0, reverse=reverse)
    t_steps, batch, hidden = dims
    if hidden % 32:
        return lstm_fwd_padded(lstm_fwd, xg, w_hh_t, h0, c0,
                               reverse=reverse, plan=plan, route=route)
    outs = _outputs(xg, h0, (t_steps, batch, hidden))
    if batch == 0:
        return outs
    route = _route(route, t_steps, batch, hidden, 1, xg.element_size())
    _LAUNCH[route](xg, w_hh_t, h0, c0, outs, 1, reverse, plan)
    return outs


def lstm_fwd_bidir(xg: torch.Tensor, w_hh_t: torch.Tensor,
                   h0: torch.Tensor, c0: torch.Tensor, *, plan=None,
                   route: str | None = None):
    """Both directions of a BiLSTM: direction 0 walks forward, direction 1
    walks t = T-1 .. 0 and writes ys[1, t] in place (no flip).

    xg (2, T, B, 4H) float32/bfloat16; w_hh_t (2, H, 4H) in xg's dtype;
    h0, c0 (2, B, H) float32. Returns ys (2, T, B, H) in xg's dtype and
    hT, cT (2, B, H) float32 (contract of ``lstm_fwd_bidir_plain``).

    CPU tensors take the plain version. CUDA tensors run both directions
    in one launch of lstm_cluster.cu, lstm_wave.cu or lstm_wide.cu (as
    ``fwd_route`` gives for 2 directions). ``route`` and ``plan`` as in
    ``lstm_fwd``; H not a multiple of 32 runs padded, as there.
    """
    dims = _check(xg, w_hh_t, h0, c0, ndir=2)
    if dims is None:
        return lstm_fwd_bidir_plain(xg, w_hh_t, h0, c0)
    t_steps, batch, hidden = dims
    if hidden % 32:
        return lstm_fwd_padded(lstm_fwd_bidir, xg, w_hh_t, h0, c0,
                               plan=plan, route=route)
    outs = _outputs(xg, h0, (2, t_steps, batch, hidden))
    if batch == 0:
        return outs
    route = _route(route, t_steps, batch, hidden, 2, xg.element_size())
    _LAUNCH[route](xg, w_hh_t, h0, c0, outs, 2, False, plan)
    return outs


def padded_hidden(hidden: int) -> int:
    """H rounded up to a multiple of 32: the width at which the kernels
    run an LSTM of H units."""
    return -(-hidden // 32) * 32


def pad_gates(t: torch.Tensor, hp: int) -> torch.Tensor:
    """(..., 4H) -> (..., 4Hp): zeros after each of the four gate blocks."""
    h = t.shape[-1] // 4
    return F.pad(t.unflatten(-1, (4, h)), (0, hp - h)).flatten(-2)


def pad_units(t: torch.Tensor, hp: int) -> torch.Tensor:
    """(..., H) -> (..., Hp): zeros after the H units."""
    return F.pad(t, (0, hp - t.shape[-1]))


def lstm_fwd_padded(fn, xg, w_hh_t, h0, c0, **kw):
    """``fn`` (``lstm_fwd``, ``lstm_fwd_bidir`` or a plain version) on the
    LSTM padded to ``padded_hidden(H)`` units: zeros after each gate block
    of xg and of W_hh's columns, zero rows of W_hh, zeros in h0 and c0.
    Returns (ys, hT, cT) sliced back to H. Exact: a padded unit's gates
    are 0 (i = f = o = 1/2, g = 0), so its c and h stay 0 and the padded
    rows of W_hh, which are 0, add nothing to the real units."""
    h = h0.shape[-1]
    hp = padded_hidden(h)
    w = F.pad(pad_gates(w_hh_t, hp), (0, 0, 0, hp - h))
    outs = fn(pad_gates(xg, hp), w, pad_units(h0, hp), pad_units(c0, hp),
              **kw)
    return tuple(o[..., :h].contiguous() for o in outs)


def lstm_bwd_padded(fn, g, w_hh, c0, dys, dh_t=None, dc_t=None, **kw):
    """``fn`` (``lstm_bwd``, ``lstm_bwd_bidir`` or a plain version) on the
    LSTM padded as ``lstm_fwd_padded`` pads it: zeros after each gate block
    of g, zero columns and gate rows of W_hh, zeros in c0, dys, dhT and
    dcT. Writes the dgates of the H units back over g and returns (g, dh0,
    dc0), dh0 and dc0 sliced back to H. Exact: a padded unit's dh is 0
    (W_hh's padded columns are 0), and with dc = dy = 0 its dgates are 0."""
    h = c0.shape[-1]
    hp = padded_hidden(h)
    w = pad_units(w_hh, hp).unflatten(-2, (4, h))
    w = F.pad(w, (0, 0, 0, hp - h)).flatten(-3, -2)
    carries = [None if t is None else pad_units(t, hp) for t in (dh_t, dc_t)]
    gp, dh0, dc0 = fn(pad_gates(g, hp), w, pad_units(c0, hp),
                      pad_units(dys, hp), *carries, **kw)
    g.copy_(gp.unflatten(-1, (4, hp))[..., :h].flatten(-2))
    return g, dh0[..., :h].contiguous(), dc0[..., :h].contiguous()


def lstm_bwd_plain(g: torch.Tensor, w_hh: torch.Tensor, c0: torch.Tensor,
                   dys: torch.Tensor, dh_t: torch.Tensor | None = None,
                   dc_t: torch.Tensor | None = None, *,
                   reverse: bool = False):
    """Step loop of ``_lstm_backward``'s replay and reverse walk, without
    the weight sums.

    g (T, B, 4H) float32, the gate pre-activations x@W_ihᵀ + b +
    h_prev@W_hhᵀ of the forward (h_prev = h0 at the first walk step);
    w_hh (4H, H) in ys's dtype; c0 (B, H) float32; dys (T, B, H) in ys's
    dtype; dh_t, dc_t (B, H) float32 or None (zeros). ``reverse`` is the
    forward's walk (t = T-1 .. 0). Writes dgates over g and returns
    (g, dh0, dc0), dh0 and dc0 (B, H) float32.
    """
    t_steps = g.shape[0]
    w = w_hh.float()
    order = range(t_steps - 1, -1, -1) if reverse else range(t_steps)
    order = list(order)
    c = c0.float()
    cs = []
    for t in order:                                  # replay of c
        i, f, gg, _ = g[t].chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        cs.append(c)
    dh = torch.zeros_like(c) if dh_t is None else dh_t.float()
    dc = torch.zeros_like(c) if dc_t is None else dc_t.float()
    for s in range(t_steps - 1, -1, -1):             # the reverse walk
        t = order[s]
        c_prev = cs[s - 1] if s else c0.float()
        i, f, gg, o = g[t].chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        gg = torch.tanh(gg)
        tc = torch.tanh(cs[s])
        dh_tot = dys[t].float() + dh
        dct = dc + dh_tot * o * (1.0 - tc * tc)
        g[t] = torch.cat([dct * gg * i * (1.0 - i),
                          dct * c_prev * f * (1.0 - f),
                          dct * i * (1.0 - gg * gg),
                          dh_tot * tc * o * (1.0 - o)], dim=-1)
        dh = g[t] @ w
        dc = dct * f
    return g, dh, dc


def lstm_bwd_bidir_plain(g, w_hh, c0, dys, dh_t=None, dc_t=None):
    """Both directions of a BiLSTM: ``lstm_bwd_plain`` on [0] (forward
    walk) and [1] (t = T-1 .. 0). Shapes as ``lstm_bwd_bidir``."""
    outs = [lstm_bwd_plain(g[d], w_hh[d], c0[d], dys[d],
                           None if dh_t is None else dh_t[d],
                           None if dc_t is None else dc_t[d],
                           reverse=bool(d)) for d in range(2)]
    return g, torch.stack([o[1] for o in outs]), torch.stack(
        [o[2] for o in outs])


def _check_bwd(g, w_hh, c0, dys, dh_t, dc_t, ndir: int | None = None):
    """Checks K2's inputs; fills dh_t/dc_t None with zeros. Returns
    (dims or None for CPU tensors, dh_t, dc_t)."""
    lead = () if ndir is None else (ndir,)
    nd = len(lead)
    if (g.dim() != 3 + nd or g.shape[-1] % 4 or tuple(g.shape[:nd]) != lead
            or g.dtype != torch.float32):
        want = "(2, T, B, 4H)" if nd else "(T, B, 4H)"
        raise ValueError(f"g must be float32 {want}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    t_steps, batch, four_h = g.shape[nd:]
    hidden = four_h // 4
    if dys.dtype not in _DTYPES or w_hh.dtype != dys.dtype:
        raise TypeError(f"dys and w_hh must share ys's dtype (float32 or "
                        f"bfloat16), got {dys.dtype} and {w_hh.dtype}")
    if tuple(dys.shape) != lead + (t_steps, batch, hidden):
        raise ValueError(f"dys must be {lead + (t_steps, batch, hidden)}, "
                         f"got {tuple(dys.shape)}")
    if tuple(w_hh.shape) != lead + (four_h, hidden):
        raise ValueError(f"w_hh must be {lead + (four_h, hidden)}, got "
                         f"{tuple(w_hh.shape)}")
    dh_t = torch.zeros_like(c0) if dh_t is None else dh_t
    dc_t = torch.zeros_like(c0) if dc_t is None else dc_t
    for name, s in (("c0", c0), ("dh_t", dh_t), ("dc_t", dc_t)):
        if s.dtype != torch.float32 or tuple(s.shape) != lead + (batch,
                                                                  hidden):
            raise ValueError(f"{name} must be float32 {lead + (batch, hidden)}"
                             f", got {s.dtype} {tuple(s.shape)}")
    tensors = (g, w_hh, c0, dys, dh_t, dc_t)
    if not g.is_cuda:
        if any(t.is_cuda for t in tensors):
            raise ValueError("lstm_bwd: inputs on mixed devices")
        return None, dh_t, dc_t
    if any(t.device != g.device for t in tensors):
        raise ValueError("lstm_bwd: inputs on mixed devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lstm_bwd: inputs must be contiguous")
    if hidden > BWD_MAX_HIDDEN:
        raise ValueError(f"lstm_bwd: hidden={hidden}: the CUDA backward "
                         f"takes H up to {BWD_MAX_HIDDEN}")
    return (t_steps, batch, hidden), dh_t, dc_t


def lstm_bwd(g: torch.Tensor, w_hh: torch.Tensor, c0: torch.Tensor,
             dys: torch.Tensor, dh_t: torch.Tensor | None = None,
             dc_t: torch.Tensor | None = None, *, reverse: bool = False,
             plan=None, route: str | None = None):
    """One direction of K2 (contract of ``lstm_bwd_plain``): dgates
    written over g, and dh0, dc0.

    CPU tensors take the plain version. CUDA tensors launch one kernel,
    chosen by shape (``bwd_route``): lstm_bwd_cluster.cu or
    lstm_bwd_wave.cu. ``route`` ("cluster" or "wave") names the kernel
    instead, to hold or time one at any shape; ``plan`` overrides the
    route's plan (``bwd_cluster_plan``'s (N, Bt, KS, UPT), ``bwd_wave_plan``'s
    rows a thread, at H = 128 its tile; ``bwd_wide_plan``'s rows a thread).
    Any B; H up to 1024 (32, 64, 128 or 256 on lstm_bwd_wave.cu, above 256
    on lstm_bwd_wide.cu only), run padded to a multiple of 32
    (``lstm_bwd_padded``) where it is not one.
    """
    dims, dh_t, dc_t = _check_bwd(g, w_hh, c0, dys, dh_t, dc_t)
    if dims is None:
        return lstm_bwd_plain(g, w_hh, c0, dys, dh_t, dc_t, reverse=reverse)
    if dims[2] % 32:
        return lstm_bwd_padded(lstm_bwd, g, w_hh, c0, dys, dh_t, dc_t,
                               reverse=reverse, plan=plan, route=route)
    return _launch_bwd(_bwd_route(route, dims, 1, dys.element_size()), g,
                       w_hh, c0, dys, dh_t, dc_t, dims, 1, reverse, plan)


def lstm_bwd_bidir(g: torch.Tensor, w_hh: torch.Tensor, c0: torch.Tensor,
                   dys: torch.Tensor, dh_t: torch.Tensor | None = None,
                   dc_t: torch.Tensor | None = None, *, plan=None,
                   route: str | None = None):
    """Both directions of K2 in one launch: direction 0 walked forward,
    direction 1 walked t = T-1 .. 0 (as ``lstm_fwd_bidir``).

    g (2, T, B, 4H) float32; w_hh (2, 4H, H) and dys (2, T, B, H) in ys's
    dtype; c0, dh_t, dc_t (2, B, H) float32 (dh_t/dc_t None: zeros).
    Returns (g holding dgates, dh0, dc0) (contract of
    ``lstm_bwd_bidir_plain``). CUDA tensors launch the kernel ``bwd_route``
    gives two directions once for both (``route`` and ``plan`` as in
    ``lstm_bwd``).
    """
    dims, dh_t, dc_t = _check_bwd(g, w_hh, c0, dys, dh_t, dc_t, ndir=2)
    if dims is None:
        return lstm_bwd_bidir_plain(g, w_hh, c0, dys, dh_t, dc_t)
    if dims[2] % 32:
        return lstm_bwd_padded(lstm_bwd_bidir, g, w_hh, c0, dys, dh_t, dc_t,
                               plan=plan, route=route)
    return _launch_bwd(_bwd_route(route, dims, 2, dys.element_size()), g,
                       w_hh, c0, dys, dh_t, dc_t, dims, 2, False, plan)


BWD_COUNTERS = {"lstm_bwd_cluster": launches_bwd_cluster,
                "lstm_bwd_wave": launches_bwd_wave,
                "lstm_bwd_wide": launches_bwd_wide}
BWD_SOURCES = {"cluster": "lstm_bwd_cluster", "wave": "lstm_bwd_wave",
               "wide": "lstm_bwd_wide"}


def _bwd_route(route, dims, ndir, itemsize):
    """The route asked for, or ``bwd_route``'s; another name, "wide" at H
    up to 256 or another route above it, is refused."""
    if route is None:
        return bwd_route(*dims, ndir, itemsize)
    if route not in BWD_SOURCES or (
            (route == "wide") != (dims[2] > CLUSTER_MAX_HIDDEN)):
        raise ValueError(f"lstm_bwd: no route {route!r} at hidden="
                         f"{dims[2]}")
    return route


def _aligned(t):
    """t itself when its data is 16-byte aligned (lstm_bwd_wave.cu's bulk
    copies and 16-byte loads), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_bwd(route, g, w_hh, c0, dys, dh_t, dc_t, dims, ndir, reverse,
                plan=None):
    """One launch of K2's kernel on `route` ("cluster" or "wave") on
    checked CUDA inputs, with that kernel's ``plan`` or its rule's."""
    t_steps, batch, hidden = dims
    name = BWD_SOURCES[route]
    dh0, dc0 = torch.empty_like(c0), torch.empty_like(c0)
    if batch == 0:
        return g, dh0, dc0
    work = g
    if route in ("wave", "wide"):
        plan = (plan or (bwd_wave_plan(hidden, dys.element_size(), batch,
                                       ndir) if route == "wave" else
                         bwd_wide_plan(hidden, batch, ndir)),)
        work = _aligned(g)
        # a float32 W_hh: each value feeds 4 FMAs a row there, too few to
        # widen a bfloat16 one in the kernel's loop
        w_hh = w_hh.float()
        w_hh, c0, dys, dh_t, dc_t = map(_aligned, (w_hh, c0, dys, dh_t, dc_t))
        what = "(rows={})"
    else:
        plan = plan or bwd_cluster_plan(hidden, dys.element_size())
        what = "(N={}, Bt={}, KS={}, UPT={})"
    cs = torch.empty(dys.shape, dtype=torch.float32, device=g.device)
    lib = _library(name)
    err = getattr(lib, name)(
        work.data_ptr(), cs.data_ptr(), w_hh.data_ptr(), c0.data_ptr(),
        dys.data_ptr(), dh_t.data_ptr(), dc_t.data_ptr(), dh0.data_ptr(),
        dc0.data_ptr(), t_steps, batch, hidden, ndir, int(reverse),
        int(dys.dtype == torch.bfloat16), *plan, g.device.index, _stream(g))
    if err:
        raise RuntimeError(f"{name} launch failed {what.format(*plan)}: "
                           + getattr(lib, f"{name}_error_string")(err)
                           .decode())
    BWD_COUNTERS[name].add()
    if work is not g:
        g.copy_(work)
    return g, dh0, dc0


def _outputs(xg, h0, ys_shape):
    return (torch.empty(ys_shape, dtype=xg.dtype, device=xg.device),
            torch.empty_like(h0), torch.empty_like(h0))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_cluster(xg, w_hh_t, h0, c0, outs, ndir, reverse, plan):
    t_steps, batch, four_h = xg.shape[-3:]
    hidden = four_h // 4
    n, bt, ks = plan or cluster_plan(hidden, xg.element_size(), batch, ndir)
    lib = _library("lstm_cluster")
    ys, h_t, c_t = outs
    err = lib.lstm_cluster(
        xg.data_ptr(), w_hh_t.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        ys.data_ptr(), h_t.data_ptr(), c_t.data_ptr(), t_steps, batch,
        hidden, ndir, int(reverse), int(xg.dtype == torch.bfloat16), n, bt,
        ks, xg.device.index, _stream(xg))
    if err:
        raise RuntimeError(
            f"lstm_cluster launch failed (N={n}, Bt={bt}, KS={ks}): "
            + lib.lstm_cluster_error_string(err).decode())
    launches.add()


def _launch_wave(xg, w_hh_t, h0, c0, outs, ndir, reverse, plan):
    t_steps, batch, four_h = xg.shape[-3:]
    hidden = four_h // 4
    rows = plan or wave_plan(hidden, xg.element_size(), batch, ndir)
    if xg.data_ptr() % 16:
        xg = xg.clone()            # the kernel's bulk copies take 16 B
    lib = _library("lstm_wave")
    ys, h_t, c_t = outs
    err = lib.lstm_wave(
        xg.data_ptr(), w_hh_t.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        ys.data_ptr(), h_t.data_ptr(), c_t.data_ptr(), t_steps, batch,
        hidden, ndir, int(reverse), int(xg.dtype == torch.bfloat16), rows,
        xg.device.index, _stream(xg))
    if err:
        raise RuntimeError(f"lstm_wave launch failed (rows={rows}): "
                           + lib.lstm_wave_error_string(err).decode())
    launches_wave.add()


def wide_weights(w_hh_t: torch.Tensor) -> torch.Tensor:
    """W_hh^T (..., H, 4H) in lstm_wide.cu's layout (..., H, H, 4): the four
    gate columns of each unit side by side, one 16-byte load a k."""
    hidden = w_hh_t.shape[-2]
    return w_hh_t.unflatten(-1, (4, hidden)).transpose(-1, -2).contiguous()


def _launch_wide(xg, w_hh_t, h0, c0, outs, ndir, reverse, plan):
    t_steps, batch, four_h = xg.shape[-3:]
    hidden = four_h // 4
    rows = plan or wide_plan(hidden, batch, ndir)
    w4 = wide_weights(w_hh_t)
    lib = _library("lstm_wide")
    ys, h_t, c_t = outs
    err = lib.lstm_wide(
        xg.data_ptr(), w4.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        ys.data_ptr(), h_t.data_ptr(), c_t.data_ptr(), t_steps, batch,
        hidden, ndir, int(reverse), int(xg.dtype == torch.bfloat16), rows,
        xg.device.index, _stream(xg))
    if err:
        raise RuntimeError(f"lstm_wide launch failed (rows={rows}): "
                           + lib.lstm_wide_error_string(err).decode())
    launches_wide.add()


_LAUNCH = {"cluster": _launch_cluster, "wave": _launch_wave,
           "wide": _launch_wide}


def _route(route, t_steps, batch, hidden, ndir, itemsize):
    """The route asked for, or ``fwd_route``'s; a cluster or wave route
    above H = 256, or a wide route up to it, is refused."""
    if route is None:
        return fwd_route(t_steps, batch, hidden, ndir, itemsize)
    if route not in _LAUNCH or (
            (route == "wide") != (hidden > CLUSTER_MAX_HIDDEN)):
        raise ValueError(f"lstm_fwd: no route {route!r} at hidden={hidden}")
    return route


_ARGTYPES = {
    # xg w_hh_t h0 c0 ys hT cT, then the ints, then the stream
    "lstm_cluster": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
    + [ctypes.c_void_p],
    "lstm_wave": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "lstm_wide": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    # g cs w_hh c0 dys dhT dcT dh0 dc0, then the ints, then the stream
    "lstm_bwd_cluster": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
    + [ctypes.c_void_p],
    "lstm_bwd_wave": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "lstm_bwd_wide": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
}


def _library(name: str) -> ctypes.CDLL:
    lib = load_library(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
    return lib
