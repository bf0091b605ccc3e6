"""FLOPs and parameter accounting (port of ``fnssl_tpu/utils/flops.py``).

Writes the reference's ``FLOPs.yaml`` schema {flops_forward,
flops_backward, params, fs, audio_time_len, num_chns} (plus
``bytes_accessed_forward``, as the JAX package), so runs stay
cost-comparable with reference runs (*/utils/flops.py:28-156).

The counts come from ``torch.utils.flop_counter.FlopCounterMode``, which
counts the matmuls, convolutions and attention products of the ops it
sees (2 FLOPs a multiply-add) and nothing else; the JAX package takes
XLA's cost analysis, which counts every op, so the figures of the two
packages are not the same. K1's custom ops (``kernels.ops.lstm_fwd`` and
``lstm_fwd_bidir``) get a formula here, the recurrence's h @ W_hhᵀ, so an
LSTM forward counts on the CPU as on the card. The selective scan (K3)
has no matmul and counts 0; K2 and K4 are launched outside the
dispatcher, so on the card a backward misses their products, and on the
CPU their plain versions' matmuls count. No byte count is taken:
``bytes_accessed`` is -1.0, the JAX package's value where XLA gives none.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Mapping

import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from fnssl_tpu_torch.kernels import ops


@register_flop_formula([getattr(torch.ops, ops.NAMESPACE).lstm_fwd,
                        getattr(torch.ops, ops.NAMESPACE).lstm_fwd_bidir])
def _recurrence_flops(xg_shape, w_hh_t_shape, *args, out_shape=None,
                      **kwargs) -> int:
    """K1's h @ W_hhᵀ: 2·H FLOPs for each of xg's (ndir,) T·B·4H gate
    entries."""
    return 2 * w_hh_t_shape[-2] * math.prod(xg_shape)


def cost_analysis(fn: Callable, *args) -> dict:
    """FLOPs of one call ``fn(*args)`` (FlopCounterMode's count), and
    ``bytes_accessed`` -1.0 (not counted)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": -1.0}


def count_params(params) -> int:
    """Parameter count of a module, or of a mapping of arrays (a state
    dict)."""
    if isinstance(params, torch.nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    if isinstance(params, Mapping):
        return int(sum(count_params(v) for v in params.values()))
    return int(torch.as_tensor(params).numel())


def flops_forward_backward(module: torch.nn.Module,
                           example: torch.Tensor) -> dict:
    """FLOPs of the forward and of the backward of ``sum(module(x)**2)``
    (the forward and backward counted together, less the forward)."""
    fwd = cost_analysis(lambda x: module(x), example)

    def loss_and_grad(x):
        module.zero_grad(set_to_none=True)
        (module(x) ** 2).sum().backward()

    fwdbwd = cost_analysis(loss_and_grad, example)
    module.zero_grad(set_to_none=True)
    return {"flops_forward": fwd["flops"],
            "flops_backward": max(fwdbwd["flops"] - fwd["flops"], 0.0),
            "bytes_accessed_forward": fwd["bytes_accessed"],
            "params": count_params(module)}


def write_flops(module: torch.nn.Module, example: torch.Tensor,
                save_dir: str, fs: int = 16000,
                audio_time_len: float = 4.79, num_chns: int = 2) -> dict:
    """Write FLOPs.yaml in the reference schema (utils/flops.py:33-49): a
    flat mapping of numbers, one ``key: value`` line each, keys sorted
    (as ``yaml.safe_dump`` writes them)."""
    stats = flops_forward_backward(module, example)
    stats.update(fs=fs, audio_time_len=audio_time_len, num_chns=num_chns)
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "FLOPs.yaml"), "w") as f:
        for k in sorted(stats):
            f.write(f"{k}: {stats[k]!r}\n")
    return stats
