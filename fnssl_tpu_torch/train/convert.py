"""Weights across the two packages and the reference's checkpoint
formats (port of ``fnssl_tpu/train/convert.py``).

The JAX parameter pytrees use the reference's state-dict names verbatim
(``block_1.fullLstm.weight_ih_l0`` as nested dicts), so a pytree turned
into numpy arrays flattens straight into a state dict that the port's
modules load with ``strict=True``. The port's parameters are that state
dict, so JAX's ``torch_state_dict_to_params`` has no counterpart and its
``params_to_torch_state_dict`` is ``params_to_state_dict`` here.
Reference formats: the raw-torch ``.tar`` (``load_torch_tar``,
``save_torch_tar``) and Lightning's ``.ckpt`` (``load_lightning_ckpt``).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def flat_to_nested(flat: Mapping[str, Any], strip_prefix: str = ""
                   ) -> dict[str, Any]:
    """'a.b.c' → nested dicts of numpy arrays (the JAX pytree layout),
    ``strip_prefix`` dropped from the keys that carry it."""
    out: dict[str, Any] = {}
    for key, val in flat.items():
        if strip_prefix and key.startswith(strip_prefix):
            key = key[len(strip_prefix):]
        parts = key.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = (val.detach().cpu().numpy()
                           if isinstance(val, torch.Tensor)
                           else np.asarray(val))
    return out


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


def load_lightning_ckpt(path: str, strip_prefix: str = "arch."
                        ) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """Read a Lightning ``.ckpt`` (its 'state_dict' keys prefixed 'arch.',
    FN-SSL/Model.py:92-99) into a state dict the port's modules load, with
    ``strip_prefix`` dropped from the keys that carry it. Returns
    (state_dict, meta), meta holding 'epoch' and 'global_step' where the
    checkpoint has them."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = {(k[len(strip_prefix):] if strip_prefix
              and k.startswith(strip_prefix) else k): torch.as_tensor(v)
             for k, v in ckpt["state_dict"].items()}
    meta = {k: ckpt[k] for k in ("epoch", "global_step") if k in ckpt}
    return state, meta


def save_torch_tar(path: str, state_dict: Mapping[str, torch.Tensor],
                   epoch: int = 0, max_score: float = 0.0) -> None:
    """Write a reference ``.tar`` checkpoint."""
    model = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save({"epoch": epoch, "max_score": max_score, "model": model},
               path)
