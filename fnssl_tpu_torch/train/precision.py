"""bf16 mixed-precision training policy (port of
``fnssl_tpu/train/precision.py``, the reference's AMP analogue).

Policy (params fp32, compute bf16, loss/grads/update fp32):
  * master params stay float32 in the module;
  * params and the input are cast to bfloat16 around the model call,
    which runs through ``torch.func.functional_call`` with the cast
    params;
  * the output is cast back to float32, so the loss accumulates in fp32,
    and the gradients reach the fp32 masters through the cast;
  * the optimizer update is pure fp32.

The STFT and the targets stay fp32. ``torch.autocast`` is not used: it
rounds in other places than the JAX package's policy.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch

PRECISIONS = ("fp32", "bf16")


def cast_floats(tree, dtype):
    """Cast a tensor, or every tensor of a mapping, to ``dtype`` if it is
    floating (ints, bools and complex tensors pass through)."""
    if isinstance(tree, Mapping):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def wrap_apply(apply_fn, precision: str = "fp32"):
    """Wrap ``apply_fn(params, x, **kw)`` in the compute-precision policy.

    'fp32' returns apply_fn unchanged; 'bf16' casts params and inputs to
    bfloat16 for the call and the outputs back to float32.
    """
    if precision in ("fp32", "float32", None):
        return apply_fn
    if precision not in ("bf16", "bfloat16"):
        raise ValueError(f"unknown precision {precision!r}; "
                         f"choose from {PRECISIONS}")

    def wrapped(params, x, **kw):
        out = apply_fn(cast_floats(params, torch.bfloat16),
                       cast_floats(x, torch.bfloat16), **kw)
        return cast_floats(out, torch.float32)

    return wrapped
