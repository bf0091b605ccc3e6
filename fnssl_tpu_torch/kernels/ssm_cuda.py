"""The selective scan of a Mamba block: the hand-written Hopper kernels and
their plain versions.

K3, the forward, and K4, its backward, replace the sequential core of
``fnssl_tpu/models/mamba.py: ssm_scan`` (``_ssm_scan_ref``, a ``lax.scan``,
and the vjp through it, ``_ssm_bwd``): one CUDA C++ source for ``sm_90a``,
``csrc/ssm_scan.cu``, bound with ``ctypes``. Its header comment says what
bounds the two kernels on the card and how they respond.

Layout: batch-major, as ``models.mamba._ssm_inputs`` produces it (no
time-major copy of the (B, L, d, n) tensors): da, dbx (B, L, d, n) and
c (B, L, n) float32 or bfloat16, h0 (B, d, n) float32; y (B, L, d) and the
states float32, as JAX computes a scan of bfloat16 inputs against a
float32 state. n (d_state) is 16 on the card.

Every wrapper runs the plain version for tensors on the CPU and launches
the kernel for CUDA tensors; it never swaps one for the other, and a
kernel that fails to build or launch raises. Gradients go through
``models.mamba.SSMScan``, whose ``torch.autograd.Function`` runs K3
forward and K4 backward. L = 0 returns without a launch.
"""
from __future__ import annotations

import ctypes

import torch

from fnssl_tpu_torch.kernels.cuda_build import LaunchCounter, load_library

# launches of K3 and K4 (the plain versions are not counted)
launches_ssm_fwd = LaunchCounter()
launches_ssm_bwd = LaunchCounter()

_DTYPES = (torch.float32, torch.bfloat16)
D_STATE = 16                    # the kernels' n
BWD_MAX_DIM = 192               # K4: 4 x d threads a block (IPDnet2's d_inner)


def ssm_scan_fwd_plain(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
                       h0: torch.Tensor):
    """Step loop of ``_ssm_scan_ref`` in the batch-major layout.

    da, dbx (B, L, d, n), c (B, L, n) float32/bfloat16; h0 (B, d, n)
    float32. Returns y (B, L, d) and h_last (B, d, n), float32.
    """
    h = h0.float()
    ys = []
    for t in range(da.shape[1]):
        h = da[:, t].float() * h + dbx[:, t].float()
        ys.append((h * c[:, t, None, :].float()).sum(-1))
    if not ys:                                       # L = 0
        return h.new_zeros((da.shape[0], 0, da.shape[2])), h.clone()
    return torch.stack(ys, dim=1), h


def ssm_scan_bwd_plain(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
                       h0: torch.Tensor, dy: torch.Tensor,
                       dh_last: torch.Tensor):
    """The vjp of ``ssm_scan_fwd_plain`` as an explicit reverse loop.

    Inputs as ``ssm_scan_fwd_plain`` and dy (B, L, d), dh_last (B, d, n)
    float32. Returns d(da), d(dbx) (B, L, d, n) and d(c) (B, L, n) in the
    inputs' dtype (float32 sums, rounded once), and d(h0) (B, d, n)
    float32.
    """
    steps = da.shape[1]
    hs = [h0.float()]
    for t in range(steps):                           # replay of h
        hs.append(da[:, t].float() * hs[-1] + dbx[:, t].float())
    dda = torch.empty_like(da)
    ddbx = torch.empty_like(dbx)
    dc = torch.empty_like(c)
    g = dh_last.float()
    for t in range(steps - 1, -1, -1):               # the reverse walk
        gy = dy[:, t].float()[..., None]             # (B, d, 1)
        gh = g + gy * c[:, t, None, :].float()
        ddbx[:, t] = gh.to(dbx.dtype)
        dda[:, t] = (gh * hs[t]).to(da.dtype)
        dc[:, t] = (gy * hs[t + 1]).sum(1).to(c.dtype)
        g = gh * da[:, t].float()
    return dda, ddbx, dc, g.clone() if steps == 0 else g


def _check(da, dbx, c, h0, extra=()):
    """Checks the shared inputs (and dy, dh_last); returns (B, L, d, n)
    for CUDA tensors, None for CPU ones."""
    if da.dim() != 4 or dbx.shape != da.shape:
        raise ValueError(f"da and dbx must be (B, L, d, n), got "
                         f"{tuple(da.shape)} and {tuple(dbx.shape)}")
    batch, steps, dim, n = da.shape
    if da.dtype not in _DTYPES or dbx.dtype != da.dtype or \
            c.dtype != da.dtype:
        raise TypeError(f"da, dbx and c must share float32 or bfloat16, got "
                        f"{da.dtype}, {dbx.dtype}, {c.dtype}")
    if tuple(c.shape) != (batch, steps, n):
        raise ValueError(f"c must be {(batch, steps, n)}, got "
                         f"{tuple(c.shape)}")
    want = {"h0": (batch, dim, n)}
    if extra:
        want.update(dy=(batch, steps, dim), dh_last=(batch, dim, n))
    tensors = (da, dbx, c, h0) + tuple(extra)
    for (name, shape), t in zip(want.items(), tensors[3:]):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not da.is_cuda:
        if any(t.is_cuda for t in tensors):
            raise ValueError("ssm_scan: inputs on mixed devices")
        return None
    if any(t.device != da.device for t in tensors):
        raise ValueError("ssm_scan: inputs on mixed devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("ssm_scan: no backward through a direct call; "
                           "take gradients through models.mamba.SSMScan")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssm_scan: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("ssm_scan: inputs must be 16-byte aligned")
    if n != D_STATE:
        raise ValueError(f"ssm_scan: d_state={n}; the CUDA kernels take "
                         f"{D_STATE}")
    return batch, steps, dim, n


def ssm_scan_fwd(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
                 h0: torch.Tensor):
    """K3 (contract of ``ssm_scan_fwd_plain``): y (B, L, d) and h_last.
    CPU tensors take the plain version; CUDA tensors launch
    ssm_scan.cu's forward once."""
    dims = _check(da, dbx, c, h0)
    if dims is None:
        return ssm_scan_fwd_plain(da, dbx, c, h0)
    batch, steps, dim, n = dims
    y = torch.empty((batch, steps, dim), dtype=torch.float32,
                    device=da.device)
    if steps == 0 or batch == 0:
        return y, h0.clone()
    h_last = torch.empty_like(h0)
    lib = _library()
    err = lib.ssm_scan_fwd(da.data_ptr(), dbx.data_ptr(), c.data_ptr(),
                           h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                           batch, steps, dim, n,
                           int(da.dtype == torch.bfloat16), da.device.index,
                           _stream(da))
    if err:
        raise RuntimeError("ssm_scan_fwd launch failed: "
                           + lib.ssm_scan_error_string(err).decode())
    launches_ssm_fwd.add()
    return y, h_last


def ssm_scan_bwd(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
                 h0: torch.Tensor, dy: torch.Tensor, dh_last: torch.Tensor):
    """K4 (contract of ``ssm_scan_bwd_plain``): d(da), d(dbx), d(c) and
    d(h0). CPU tensors take the plain version; CUDA tensors launch
    ssm_scan.cu's backward once (d a multiple of 8 up to 192)."""
    dims = _check(da, dbx, c, h0, (dy, dh_last))
    if dims is None:
        return ssm_scan_bwd_plain(da, dbx, c, h0, dy, dh_last)
    batch, steps, dim, n = dims
    dda, ddbx, dc = (torch.empty_like(t) for t in (da, dbx, c))
    if steps == 0 or batch == 0:
        return dda, ddbx, dc, dh_last.clone()
    if dim % 8 or dim > BWD_MAX_DIM:
        raise ValueError(f"ssm_scan_bwd: d={dim} must be a multiple of 8 "
                         f"up to {BWD_MAX_DIM}")
    dh0 = torch.empty_like(h0)
    ck = torch.empty((batch, -(-steps // 4), dim, n), dtype=torch.float32,
                     device=da.device)
    lib = _library()
    err = lib.ssm_scan_bwd(da.data_ptr(), dbx.data_ptr(), c.data_ptr(),
                           h0.data_ptr(), dy.data_ptr(), dh_last.data_ptr(),
                           dda.data_ptr(), ddbx.data_ptr(), dc.data_ptr(),
                           dh0.data_ptr(), ck.data_ptr(), batch, steps, dim,
                           n, int(da.dtype == torch.bfloat16),
                           da.device.index, _stream(da))
    if err:
        raise RuntimeError("ssm_scan_bwd launch failed: "
                           + lib.ssm_scan_error_string(err).decode())
    launches_ssm_bwd.add()
    return dda, ddbx, dc, dh0


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


_ARGTYPES = {
    # da dbx c h0 y h_last, then the ints, then the stream
    "ssm_scan_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    # da dbx c h0 dy dh_last dda ddbx dc dh0 ck, the ints, the stream
    "ssm_scan_bwd": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}


def _library() -> ctypes.CDLL:
    lib = load_library("ssm_scan")
    if lib.ssm_scan_fwd.argtypes is None:
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib
