"""K1 (the LSTM recurrence, both entry points) and K3 (the fused selective
scan's forward) as ``torch.library`` custom ops.

A ``ctypes`` launch passes ``data_ptr()``s, which a ``torch.export`` trace
cannot follow: there every tensor is a FakeTensor. As custom ops the
kernels are single nodes of the traced graph, whose output shapes come
from each op's ``register_fake``, and an exported program runs them
through the dispatcher when it is called:

- the CUDA implementation is the wrapper's launch of the hand-written
  kernel (``lstm_cuda.lstm_fwd``/``lstm_fwd_bidir``: ``lstm_cluster.cu``,
  or ``lstm_fwd.cu`` above H = 256; ``ssm_cuda.selective_scan_fwd``:
  ``ssm_scan.cu``), launch counters included;
- the CPU implementation is the same wrapper on CPU tensors, which runs
  the plain version.

``models.lstm.LSTMRecurrence.forward`` and ``models.mamba.SSMScan.forward``
call these ops; their backwards (K2, K4) keep calling the wrappers.
Importing this module registers the ops (``runtime.export.load_artifact``
imports it and nothing of the models).
"""
from __future__ import annotations

import torch
from torch import Tensor

from fnssl_tpu_torch.kernels import lstm_cuda, ssm_cuda

NAMESPACE = "fnssl_tpu_torch"


def _unaliased(outs, inputs):
    """A custom op's outputs may not share storage with its inputs (the
    plain versions hand back h0/c0 as they are for T = 0)."""
    ptrs = {t.untyped_storage().data_ptr() for t in inputs}
    return tuple(o.clone() if o.untyped_storage().data_ptr() in ptrs else o
                 for o in outs)


@torch.library.custom_op(f"{NAMESPACE}::lstm_fwd", mutates_args=(),
                         device_types="cpu")
def lstm_fwd(xg: Tensor, w_hh_t: Tensor, h0: Tensor, c0: Tensor,
             reverse: bool = False) -> tuple[Tensor, Tensor, Tensor]:
    """One LSTM direction (contract of ``lstm_cuda.lstm_fwd``): ys (T, B,
    H) in xg's dtype, hT, cT (B, H) float32."""
    return _unaliased(lstm_cuda.lstm_fwd(xg, w_hh_t, h0, c0,
                                         reverse=reverse), (h0, c0))


@lstm_fwd.register_kernel("cuda")
def _lstm_fwd_cuda(xg, w_hh_t, h0, c0, reverse=False):
    return lstm_cuda.lstm_fwd(xg, w_hh_t, h0, c0, reverse=reverse)


@lstm_fwd.register_fake
def _lstm_fwd_fake(xg, w_hh_t, h0, c0, reverse=False):
    t_steps, batch, four_h = xg.shape
    return (xg.new_empty((t_steps, batch, four_h // 4)),
            torch.empty_like(h0), torch.empty_like(c0))


@torch.library.custom_op(f"{NAMESPACE}::lstm_fwd_bidir", mutates_args=(),
                         device_types="cpu")
def lstm_fwd_bidir(xg: Tensor, w_hh_t: Tensor, h0: Tensor,
                   c0: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Both directions of a BiLSTM (contract of
    ``lstm_cuda.lstm_fwd_bidir``): ys (2, T, B, H), hT, cT (2, B, H)."""
    return _unaliased(lstm_cuda.lstm_fwd_bidir(xg, w_hh_t, h0, c0),
                      (h0, c0))


@lstm_fwd_bidir.register_kernel("cuda")
def _lstm_fwd_bidir_cuda(xg, w_hh_t, h0, c0):
    return lstm_cuda.lstm_fwd_bidir(xg, w_hh_t, h0, c0)


@lstm_fwd_bidir.register_fake
def _lstm_fwd_bidir_fake(xg, w_hh_t, h0, c0):
    ndir, t_steps, batch, four_h = xg.shape
    return (xg.new_empty((ndir, t_steps, batch, four_h // 4)),
            torch.empty_like(h0), torch.empty_like(c0))


@torch.library.custom_op(f"{NAMESPACE}::selective_scan_fwd",
                         mutates_args=(),
                         device_types="cpu")
def selective_scan_fwd(x: Tensor, dt: Tensor, dt_bias: Tensor, a: Tensor,
                       bm: Tensor, c: Tensor, d_skip: Tensor,
                       h0: Tensor) -> tuple[Tensor, Tensor]:
    """K3, the fused selective scan (contract of
    ``ssm_cuda.selective_scan_fwd``): y (B, L, d) and h_last (B, d, n),
    float32."""
    return _unaliased(ssm_cuda.selective_scan_fwd(x, dt, dt_bias, a, bm, c,
                                                  d_skip, h0), (h0,))


@selective_scan_fwd.register_kernel("cuda")
def _selective_scan_fwd_cuda(x, dt, dt_bias, a, bm, c, d_skip, h0):
    return ssm_cuda.selective_scan_fwd(x, dt, dt_bias, a, bm, c, d_skip, h0)


@selective_scan_fwd.register_fake
def _selective_scan_fwd_fake(x, dt, dt_bias, a, bm, c, d_skip, h0):
    return (x.new_empty(x.shape, dtype=torch.float32), torch.empty_like(h0))
