"""LSTM recurrence: the hand-written Hopper kernels and their plain version.

Replaces ``fnssl_tpu/kernels/lstm_pallas.py:_lstm_kernel`` (launched by
``_lstm_pallas_fwd``). Two CUDA C++ sources for ``sm_90a``, bound with
``ctypes``, chosen by shape:

- ``csrc/lstm_cluster.cu`` for H a multiple of 32 up to 256 (every LSTM
  of the JAX package): W_hh stays in a thread-block cluster's shared
  memory, h is exchanged through distributed shared memory, and one launch
  runs one or both directions. ``cluster_plan`` picks its cluster size,
  batch tile and k-split.
- ``csrc/lstm_fwd.cu`` for H above 256 (up to 1024): one direction a
  launch, W_hh read through L2 on every step.

Each source's header comment says what bounds it on the card and how the
design responds. ``lstm_fwd`` and ``lstm_fwd_bidir`` run the plain version
for tensors on the CPU and launch a kernel for CUDA tensors; they never
swap one for the other, and a kernel that fails to build or launch raises.
The backward of the recurrence is not ported yet, so CUDA inputs that
require grad while grad is enabled are refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from fnssl_tpu_torch.kernels.cuda_build import LaunchCounter, load_library

# launches of each CUDA kernel (the plain version is not counted):
# ``launches`` for lstm_cluster.cu, ``launches_v2`` for lstm_fwd.cu
launches = LaunchCounter()
launches_v2 = LaunchCounter()

_DTYPES = (torch.float32, torch.bfloat16)

CLUSTER_MAX_HIDDEN = 256          # lstm_cluster.cu's H; lstm_fwd.cu above
# dynamic shared memory a CTA may use: 227 KB less 16 B of mbarriers
SMEM_BYTES = 232_448 - 16
MAX_THREADS = {8: 512, 16: 256}   # threads a CTA may have, by tile
CLUSTER_SIZES = (1, 2, 4, 8)      # 8 is the portable cluster limit
TILES = (8, 16)


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
def cluster_plan(hidden: int, itemsize: int, batch: int, *,
                 n: int | None = None, bt: int | None = None,
                 ks: int | None = None):
    """(N, Bt, KS) for lstm_cluster.cu: CTAs per cluster, batch rows per
    tile and the k-split inside a CTA.

    By default the largest cluster (8), 8 rows a tile and a k-slice of 16
    (KS = H/16) that fit: the fastest plan at both serve shapes on the card
    (PERF.md). ``n``, ``bt`` and ``ks`` pin any of the three, to time other
    plans. A plan fits when the CTA has <= 512 threads (256 at 16 rows a
    tile), each thread finishes at most 2 rows in the cell update, and the
    CTA's shared memory stays within 227 KB.
    """
    del batch                     # every plan takes any B (masked tiles)
    if hidden % 32 or not 32 <= hidden <= CLUSTER_MAX_HIDDEN:
        raise ValueError(f"lstm_cluster: hidden={hidden} must be a multiple "
                         f"of 32 up to {CLUSTER_MAX_HIDDEN}")
    ns = (n,) if n else CLUSTER_SIZES[::-1]
    bts = (bt,) if bt else TILES
    for b in bts:
        for m in ns:
            if m not in CLUSTER_SIZES or b not in TILES:
                raise ValueError(f"lstm_cluster: no plan with N={m}, Bt={b}")
            for k in _k_splits(hidden, itemsize, m, b):
                if ks in (None, k):
                    return m, b, k
    raise ValueError(f"lstm_cluster: no plan fits hidden={hidden}, "
                     f"itemsize={itemsize}, N={n}, Bt={bt}, KS={ks}")


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
        raise RuntimeError("lstm_fwd: the CUDA kernel has no backward yet; "
                           "run under torch.no_grad()")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lstm_fwd: inputs must be contiguous")
    if hidden % 32 or hidden > 1024:
        raise ValueError(f"lstm_fwd: hidden={hidden} must be a multiple of "
                         "32 up to 1024")
    return t_steps, batch, hidden


def lstm_fwd(xg: torch.Tensor, w_hh_t: torch.Tensor, h0: torch.Tensor,
             c0: torch.Tensor, *, reverse: bool = False, plan=None):
    """One LSTM direction over T steps (contract of ``lstm_fwd_plain``).

    CPU tensors take the plain version. CUDA tensors launch one kernel,
    chosen by shape: lstm_cluster.cu for H up to 256 (``plan`` overrides
    ``cluster_plan``'s (N, Bt, KS)), lstm_fwd.cu for H above 256 up to
    1024. Any B; H must be a multiple of 32.
    """
    dims = _check(xg, w_hh_t, h0, c0)
    if dims is None:
        return lstm_fwd_plain(xg, w_hh_t, h0, c0, reverse=reverse)
    t_steps, batch, hidden = dims
    outs = _outputs(xg, h0, (t_steps, batch, hidden))
    if batch == 0:
        return outs
    if hidden <= CLUSTER_MAX_HIDDEN:
        _launch_cluster(xg, w_hh_t, h0, c0, outs, 1, reverse, plan)
    else:
        _launch_v2(xg, w_hh_t, h0, c0, outs, reverse)
    return outs


def lstm_fwd_bidir(xg: torch.Tensor, w_hh_t: torch.Tensor,
                   h0: torch.Tensor, c0: torch.Tensor, *, plan=None):
    """Both directions of a BiLSTM: direction 0 walks forward, direction 1
    walks t = T-1 .. 0 and writes ys[1, t] in place (no flip).

    xg (2, T, B, 4H) float32/bfloat16; w_hh_t (2, H, 4H) in xg's dtype;
    h0, c0 (2, B, H) float32. Returns ys (2, T, B, H) in xg's dtype and
    hT, cT (2, B, H) float32 (contract of ``lstm_fwd_bidir_plain``).

    CPU tensors take the plain version. CUDA tensors with H up to 256 run
    both directions in one launch of lstm_cluster.cu; H above 256 launches
    lstm_fwd.cu once per direction (a choice by shape).
    """
    dims = _check(xg, w_hh_t, h0, c0, ndir=2)
    if dims is None:
        return lstm_fwd_bidir_plain(xg, w_hh_t, h0, c0)
    t_steps, batch, hidden = dims
    outs = _outputs(xg, h0, (2, t_steps, batch, hidden))
    if batch == 0:
        return outs
    if hidden <= CLUSTER_MAX_HIDDEN:
        _launch_cluster(xg, w_hh_t, h0, c0, outs, 2, False, plan)
    else:
        for d in range(2):
            _launch_v2(xg[d], w_hh_t[d], h0[d], c0[d],
                       tuple(o[d] for o in outs), bool(d))
    return outs


def _outputs(xg, h0, ys_shape):
    return (torch.empty(ys_shape, dtype=xg.dtype, device=xg.device),
            torch.empty_like(h0), torch.empty_like(h0))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_cluster(xg, w_hh_t, h0, c0, outs, ndir, reverse, plan):
    t_steps, batch, four_h = xg.shape[-3:]
    hidden = four_h // 4
    n, bt, ks = plan or cluster_plan(hidden, xg.element_size(), batch)
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


def _launch_v2(xg, w_hh_t, h0, c0, outs, reverse):
    t_steps, batch, four_h = xg.shape
    lib = _library("lstm_fwd")
    ys, h_t, c_t = outs
    err = lib.lstm_fwd(xg.data_ptr(), w_hh_t.data_ptr(), h0.data_ptr(),
                       c0.data_ptr(), ys.data_ptr(), h_t.data_ptr(),
                       c_t.data_ptr(), t_steps, batch, four_h // 4,
                       int(reverse), int(xg.dtype == torch.bfloat16),
                       xg.device.index, _stream(xg))
    if err:
        raise RuntimeError("lstm_fwd launch failed: "
                           + lib.lstm_fwd_error_string(err).decode())
    launches_v2.add()


_ARGTYPES = {
    # xg w_hh_t h0 c0 ys hT cT, then the ints, then the stream
    "lstm_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "lstm_cluster": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
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
