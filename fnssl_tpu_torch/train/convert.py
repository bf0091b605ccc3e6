"""Weights across the two packages (port of the state-dict half of
``fnssl_tpu/train/convert.py``).

The JAX parameter pytrees use the reference's state-dict names verbatim
(``block_1.fullLstm.weight_ih_l0`` as nested dicts), so a pytree turned
into numpy arrays flattens straight into a state dict that the port's
modules load with ``strict=True``.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def nested_to_flat(params: Mapping[str, Any], prefix: str = ""
                   ) -> dict[str, np.ndarray]:
    """Nested dicts → flat 'a.b.c' numpy dict."""
    out: dict[str, np.ndarray] = {}
    for key, val in params.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(nested_to_flat(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def params_to_state_dict(params: Mapping[str, Any], prefix: str = ""
                         ) -> dict[str, torch.Tensor]:
    """Nested numpy parameters (a JAX pytree as numpy arrays) → the port's
    state dict of CPU tensors."""
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in nested_to_flat(params, prefix).items()}


def load_torch_tar(path: str) -> tuple[dict[str, torch.Tensor],
                                       dict[str, Any]]:
    """Read a reference ``.tar`` checkpoint ({'epoch', 'max_score',
    'model': state_dict[, 'scalar']}). Returns (state_dict, metadata)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = {k: torch.as_tensor(v) for k, v in ckpt["model"].items()}
    meta = {k: v for k, v in ckpt.items() if k != "model"}
    return state, meta


def save_torch_tar(path: str, state_dict: Mapping[str, torch.Tensor],
                   epoch: int = 0, max_score: float = 0.0) -> None:
    """Write a reference ``.tar`` checkpoint."""
    model = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save({"epoch": epoch, "max_score": max_score, "model": model},
               path)
