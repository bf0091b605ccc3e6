"""The selective scan of a Mamba block: the hand-written Hopper kernels and
their plain versions.

K3, the forward, and K4, its backward, replace the sequential core of
``fnssl_tpu/models/mamba.py: ssm_scan`` (``_ssm_scan_ref``, a ``lax.scan``,
and the vjp through it, ``_ssm_bwd``) together with the elementwise
producers of its inputs (``_ssm_inputs``): one CUDA C++ source for
``sm_90a``, ``csrc/ssm_scan.cu``, bound with ``ctypes``. Its header comment
says what bounds the two kernels on the card and how they respond.

The fused contract, batch-major (mamba_ssm's ``selective_scan``): x, dt
(B, L, d) and bm, c (B, L, n) float32 or bfloat16 (one dtype; dt is the
dt_proj product before its bias and softplus), dt_bias (d), a = -exp(A_log)
(d, n), d_skip (D, (d)) and h0 (B, d, n) float32 → y = the scan's
contraction + D·x (B, L, d) and h_last (B, d, n), float32. exp(Δ·A) and
Δ·x·B are formed in registers: no (B, L, d, n) tensor is written on the
card, forward or backward. n (d_state) is 16 on the card.

``ssm_scan_fwd_plain`` and ``ssm_scan_bwd_plain`` keep JAX's (da, dbx)
contract of ``ssm_scan`` as the counterparts of its tests; the fused plain
versions are built on them.

Every wrapper runs the plain version for tensors on the CPU and launches
the kernel for CUDA tensors; it never swaps one for the other, and a
kernel that fails to build or launch raises. Gradients go through
``models.mamba.SSMScan``, whose ``torch.autograd.Function`` runs K3
forward and K4 backward. L = 0 returns without a launch.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fnssl_tpu_torch.kernels.cuda_build import LaunchCounter, load_library

# launches of K3 and K4 (the plain versions are not counted)
launches_ssm_fwd = LaunchCounter()
launches_ssm_bwd = LaunchCounter()

_DTYPES = (torch.float32, torch.bfloat16)
D_STATE = 16                    # the kernels' n
SEGMENT = 8                     # K4's checkpoint interval (ssm_scan.cu kGroup)
SLICE = 32                      # channels a block (ssm_scan.cu kCh)


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


def _softplus(dt, dt_bias):
    """(delta, softplus'(dt + dt_bias)) in float32: torch's softplus,
    threshold 20, and the derivative its backward takes."""
    v = dt.float() + dt_bias
    z = torch.exp(v)
    return F.softplus(v), torch.where(v > 20, torch.ones_like(v),
                                      z / (z + 1))


def selective_scan_fwd_plain(x, dt, dt_bias, a, bm, c, d_skip, h0):
    """``_ssm_inputs``' arithmetic after its products, then
    ``ssm_scan_fwd_plain``, then + D·x (the contract of the module
    docstring). bfloat16 inputs are widened to float32 first."""
    delta, _ = _softplus(dt, dt_bias)
    da = torch.exp(delta[..., None] * a)                      # (B, L, d, n)
    dbx = (delta * x.float())[..., None] * bm.float()[..., None, :]
    y, h_last = ssm_scan_fwd_plain(da, dbx, c.float(), h0)
    return y + d_skip * x.float(), h_last


def selective_scan_bwd_plain(x, dt, dt_bias, a, bm, c, d_skip, h0, dy,
                             dh_last):
    """The vjp of ``selective_scan_fwd_plain`` as an explicit reverse loop
    (no autograd), step by step as K4 computes it. Returns the gradients of
    (x, dt, dt_bias, a, bm, c, d_skip, h0): dx, d(dt) (B, L, d) and d(bm),
    d(c) (B, L, n) in the inputs' dtype (float32 sums, rounded once);
    d(dt_bias), d(a), d(d_skip) and d(h0) float32."""
    delta, dsp = _softplus(dt, dt_bias)
    xf, bf, cf = x.float(), bm.float(), c.float()
    batch, steps, dim = x.shape
    hs = [h0.float()]
    for t in range(steps):                           # replay of h
        da = torch.exp(delta[:, t, :, None] * a)
        hs.append(da * hs[-1] + (delta[:, t] * xf[:, t])[..., None]
                  * bf[:, t, None, :])
    dx, ddt = (xf.new_empty((batch, steps, dim)) for _ in range(2))
    dbm, dc = (xf.new_empty((batch, steps, a.shape[-1])) for _ in range(2))
    da_grad = torch.zeros_like(a)
    dd_grad = torch.zeros_like(d_skip)
    g = dh_last.float()
    for t in range(steps - 1, -1, -1):               # the reverse walk
        gy = dy[:, t].float()                        # (B, d)
        gh = g + gy[..., None] * cf[:, t, None, :]   # (B, d, n)
        du = delta[:, t] * xf[:, t]
        dc[:, t] = (gy[..., None] * hs[t + 1]).sum(1)
        dbm[:, t] = (gh * du[..., None]).sum(1)
        da = torch.exp(delta[:, t, :, None] * a)
        gda = gh * hs[t] * da                        # d(da) · da
        s_b = (gh * bf[:, t, None, :]).sum(-1)
        dx[:, t] = gy * d_skip + delta[:, t] * s_b
        ddt[:, t] = ((gda * a).sum(-1) + xf[:, t] * s_b) * dsp[:, t]
        da_grad += (gda * delta[:, t, :, None]).sum(0)
        dd_grad += (gy * xf[:, t]).sum(0)
        g = gh * da
    return (dx.to(x.dtype), ddt.to(dt.dtype), ddt.sum((0, 1)), da_grad,
            dbm.to(bm.dtype), dc.to(c.dtype), dd_grad,
            g.clone() if steps == 0 else g)


def _check(x, dt, dt_bias, a, bm, c, d_skip, h0, extra=()):
    """Checks the inputs (and dy, dh_last); returns (B, L, d, n) for CUDA
    tensors, None for CPU ones."""
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x and dt must be (B, L, d), got "
                         f"{tuple(x.shape)} and {tuple(dt.shape)}")
    batch, steps, dim = x.shape
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, bm, c)):
        raise TypeError(f"x, dt, bm and c must share float32 or bfloat16, "
                        f"got {x.dtype}, {dt.dtype}, {bm.dtype}, {c.dtype}")
    n = a.shape[-1] if a.dim() == 2 else -1
    want = {"bm": (batch, steps, n), "c": (batch, steps, n)}
    for (name, shape), t in zip(want.items(), (bm, c)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    want = {"dt_bias": (dim,), "a": (dim, n), "d_skip": (dim,),
            "h0": (batch, dim, n)}
    if extra:
        want.update(dy=(batch, steps, dim), dh_last=(batch, dim, n))
    floats = (dt_bias, a, d_skip, h0) + tuple(extra)
    for (name, shape), t in zip(want.items(), floats):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    tensors = (x, dt, bm, c) + floats
    if not x.is_cuda:
        if any(t.is_cuda for t in tensors):
            raise ValueError("selective_scan: inputs on mixed devices")
        return None
    if any(t.device != x.device for t in tensors):
        raise ValueError("selective_scan: inputs on mixed devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("selective_scan: no backward through a direct "
                           "call; take gradients through "
                           "models.mamba.SSMScan")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("selective_scan: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("selective_scan: inputs must be 16-byte aligned")
    if n != D_STATE:
        raise ValueError(f"selective_scan: d_state={n}; the CUDA kernels "
                         f"take {D_STATE}")
    return batch, steps, dim, n


def selective_scan_fwd(x, dt, dt_bias, a, bm, c, d_skip, h0):
    """K3 (contract of ``selective_scan_fwd_plain``): y (B, L, d) and
    h_last (B, d, n), float32. CPU tensors take the plain version; CUDA
    tensors launch ssm_scan.cu's forward once."""
    args = (x, dt, dt_bias, a, bm, c, d_skip, h0)
    dims = _check(*args)
    if dims is None:
        return selective_scan_fwd_plain(*args)
    batch, steps, dim, n = dims
    y = torch.empty((batch, steps, dim), dtype=torch.float32,
                    device=x.device)
    if steps == 0 or batch == 0:
        return y, h0.clone()
    h_last = torch.empty_like(h0)
    lib = _library()
    err = lib.selective_scan_fwd(*(t.data_ptr() for t in args),
                                 y.data_ptr(), h_last.data_ptr(), batch,
                                 steps, dim, n,
                                 int(x.dtype == torch.bfloat16),
                                 x.device.index, _stream(x))
    if err:
        raise RuntimeError("selective_scan_fwd launch failed: "
                           + lib.ssm_scan_error_string(err).decode())
    launches_ssm_fwd.add()
    return y, h_last


def selective_scan_bwd(x, dt, dt_bias, a, bm, c, d_skip, h0, dy, dh_last):
    """K4 (contract of ``selective_scan_bwd_plain``): the gradients of
    (x, dt, dt_bias, a, bm, c, d_skip, h0). CPU tensors take the plain
    version; CUDA tensors launch ssm_scan.cu's backward once, then sum its
    per-block partials (d(bm), d(c) over the slices of d; d(a), d(d_skip),
    d(dt_bias) over the batch) in a fixed order."""
    args = (x, dt, dt_bias, a, bm, c, d_skip, h0)
    dims = _check(*args, extra=(dy, dh_last))
    if dims is None:
        return selective_scan_bwd_plain(*args, dy, dh_last)
    batch, steps, dim, n = dims
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    if steps == 0 or batch == 0:
        return (dx, ddt, torch.zeros_like(dt_bias), torch.zeros_like(a),
                torch.empty_like(bm), torch.empty_like(c),
                torch.zeros_like(d_skip), dh_last.clone())
    slices = -(-dim // SLICE)

    def scratch(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    part_bc = scratch(batch, steps, slices, 2 * n)
    part_a, dh0 = scratch(batch, dim, n), torch.empty_like(h0)
    part_d, part_bias = scratch(batch, dim), scratch(batch, dim)
    ck = scratch(batch, -(-steps // SEGMENT), dim, n)
    lib = _library()
    err = lib.selective_scan_bwd(
        *(t.data_ptr() for t in args + (dy, dh_last, dx, ddt, part_bc,
                                        part_a, part_d, part_bias, dh0,
                                        ck)),
        batch, steps, dim, n, int(x.dtype == torch.bfloat16),
        x.device.index, _stream(x))
    if err:
        raise RuntimeError("selective_scan_bwd launch failed: "
                           + lib.ssm_scan_error_string(err).decode())
    launches_ssm_bwd.add()
    dbc = part_bc.sum(2)
    return (dx, ddt, part_bias.sum(0), part_a.sum(0),
            dbc[..., :n].to(bm.dtype), dbc[..., n:].to(c.dtype),
            part_d.sum(0), dh0)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


_ARGTYPES = {
    # x dt dt_bias a bm c d_skip h0 y h_last, the ints, the stream
    "selective_scan_fwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    # the 8 inputs, dy dh_last dx ddt part_bc part_a part_d part_bias dh0
    # ck, the ints, the stream
    "selective_scan_bwd": [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}


def _library() -> ctypes.CDLL:
    lib = load_library("ssm_scan")
    if lib.selective_scan_fwd.argtypes is None:
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib
