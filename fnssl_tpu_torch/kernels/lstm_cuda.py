"""LSTM recurrence: the hand-written Hopper kernel and its plain version.

Replaces ``fnssl_tpu/kernels/lstm_pallas.py:_lstm_kernel`` (launched by
``_lstm_pallas_fwd``). The kernel is ``csrc/lstm_fwd.cu``, CUDA C++ for
``sm_90a``, bound with ``ctypes``; its header comment says what bounds it
on the card and how the design responds.

``lstm_fwd`` runs the plain version for tensors on the CPU and launches
the kernel for CUDA tensors; it never swaps one for the other. The
backward of the recurrence is not ported yet, so CUDA inputs that
require grad while grad is enabled are refused.
"""
from __future__ import annotations

import ctypes

import torch

from fnssl_tpu_torch.kernels.cuda_build import LaunchCounter, load_library

# launches of the CUDA kernel (the plain version is not counted)
launches = LaunchCounter()

_DTYPES = (torch.float32, torch.bfloat16)


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


def _check(xg, w_hh_t, h0, c0):
    if xg.dim() != 3 or xg.shape[-1] % 4:
        raise ValueError(f"xg must be (T, B, 4H), got {tuple(xg.shape)}")
    t_steps, batch, four_h = xg.shape
    hidden = four_h // 4
    if xg.dtype not in _DTYPES:
        raise TypeError(f"xg must be float32 or bfloat16, got {xg.dtype}")
    if w_hh_t.dtype != xg.dtype:
        raise TypeError(f"w_hh_t must have xg's dtype {xg.dtype}, got "
                        f"{w_hh_t.dtype}")
    if tuple(w_hh_t.shape) != (hidden, four_h):
        raise ValueError(f"w_hh_t must be {(hidden, four_h)}, got "
                         f"{tuple(w_hh_t.shape)}")
    for name, s in (("h0", h0), ("c0", c0)):
        if s.dtype != torch.float32 or tuple(s.shape) != (batch, hidden):
            raise ValueError(f"{name} must be float32 {(batch, hidden)}, "
                             f"got {s.dtype} {tuple(s.shape)}")
    return t_steps, batch, hidden


def lstm_fwd(xg: torch.Tensor, w_hh_t: torch.Tensor, h0: torch.Tensor,
             c0: torch.Tensor, *, reverse: bool = False):
    """One LSTM direction over T steps (contract of ``lstm_fwd_plain``).

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes any B and any H that is a multiple of 32 up to 1024.
    """
    t_steps, batch, hidden = _check(xg, w_hh_t, h0, c0)
    tensors = (xg, w_hh_t, h0, c0)
    if not xg.is_cuda:
        if any(t.is_cuda for t in tensors):
            raise ValueError("lstm_fwd: inputs on mixed devices")
        return lstm_fwd_plain(xg, w_hh_t, h0, c0, reverse=reverse)
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
    ys = torch.empty((t_steps, batch, hidden), dtype=xg.dtype,
                     device=xg.device)
    h_t = torch.empty_like(h0)
    c_t = torch.empty_like(c0)
    if batch == 0:
        return ys, h_t, c_t
    lib = _library()
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    err = lib.lstm_fwd(xg.data_ptr(), w_hh_t.data_ptr(), h0.data_ptr(),
                       c0.data_ptr(), ys.data_ptr(), h_t.data_ptr(),
                       c_t.data_ptr(), t_steps, batch, hidden, int(reverse),
                       int(xg.dtype == torch.bfloat16), xg.device.index,
                       stream)
    if err:
        raise RuntimeError("lstm_fwd launch failed: "
                           + lib.lstm_fwd_error_string(err).decode())
    launches.add()
    return ys, h_t, c_t


def _library() -> ctypes.CDLL:
    lib = load_library("lstm_fwd")
    if lib.lstm_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.lstm_fwd.restype = ctypes.c_int
        lib.lstm_fwd_error_string.argtypes = [i]
        lib.lstm_fwd_error_string.restype = ctypes.c_char_p
    return lib
