"""Serving artifacts: ``torch.export`` programs plus the stream's initial
state (port of ``fnssl_tpu/runtime/export.py``).

A trained model serializes to a self-contained directory:

    model.<platform>.pt2  ``torch.export.save`` of the ExportedProgram of
                          the forward (or the streaming chunk step), one
                          file a platform (``cpu``, ``cuda``); the weights
                          are inside it
    init_state.pt         stream mode: the initial state, a flat list of
                          tensors (``torch.save``, read with
                          ``weights_only=True``)
    meta.json             manifest: model name, mode, input shape and
                          dtype, platforms, state leaves, package versions

``load_artifact()`` returns a callable that needs **no model code**: it
imports only ``kernels.ops``, which registers the custom ops that the
programs call for K1 and K3. On the card those ops launch the hand-written
kernels (K1 on ``lstm_cluster.cu``, ``lstm_wave.cu`` or ``lstm_wide.cu``
as ``lstm_cuda.fwd_route`` gives the shape; K3 on ``ssm_scan.cu``); in a
CPU program the same ops run their plain versions, the part the JAX
package's cross-lowering gave to its ``lax.scan`` in place of the Pallas
kernel. IPDnet2's MHSA and retention time modules are plain matrix
products in the program and call no custom op. The program is neither
compiled by AOTInductor nor by ``torch.compile``: it is run as traced,
op by op.

The stream mode's state is flattened at the artifact's boundary: the
program takes ``(feats, [leaves])`` and returns ``(pred, [new leaves])``,
so no state class has to be registered for serialization and a loader
needs none of them. The leaves are the JAX package's (``init_state.pt``
holds JAX's ``export_model`` initial state leaf for leaf).
"""
from __future__ import annotations

import copy
import json
import os
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

PLATFORMS = ("cpu", "cuda")


def _resolve(model: str, module: nn.Module, per_row: bool = True):
    """Model name → (apply_fn(module, x, state=None, return_state=False),
    init_state(nb) on the module's device, or None for a forward-only
    model). The shared head of the slot pool and of export.

    ``per_row`` (the pool's) keeps IPDnet2's MHSA and retention positions
    and running scale one a row, so that every state leaf grows with nb;
    export asks for JAX's leaves (``per_row=False``), where they are one
    for the batch. The two give the same outputs."""
    from fnssl_tpu_torch.models.fnssl import init_fnssl_state
    from fnssl_tpu_torch.models.ipdnet import init_ipdnet_state
    from fnssl_tpu_torch.models.spatialnet import init_spatialnet_state

    def apply_fn(m, x, state=None, return_state=False):
        if state is None and not return_state:
            return m(x)
        return m(x, state=state, return_state=return_state)

    if model.startswith("fnssl"):
        return apply_fn, lambda nb: init_fnssl_state(
            nb, 256, module.cfg, module.device)
    if model == "ipdnet":
        return apply_fn, lambda nb: init_ipdnet_state(
            nb, 256, module.cfg, module.device)
    if model in ("ipdnet_offline", "variable_ipdnet"):
        # the offline variant's bidirectional LSTMs and the variable
        # array's pair means have no causal streaming state: forward-only
        return (lambda m, x, state=None, return_state=False: m(x)), None
    if model == "ipdnet2":
        return apply_fn, lambda nb: init_spatialnet_state(
            nb, module.cfg, module.device, per_row)
    raise ValueError(f"export: unknown model {model!r}")


class _Program(nn.Module):
    """What is traced: the model's forward, or its chunk step on a flat
    list of state tensors."""

    def __init__(self, module: nn.Module, apply_fn: Callable, spec=None):
        super().__init__()
        self.model = module
        self._apply = apply_fn
        self._spec = spec

    def forward(self, feats, state: list | None = None):
        if self._spec is None:
            return self._apply(self.model, feats)
        out, new = self._apply(self.model, feats,
                               state=pytree.tree_unflatten(state, self._spec),
                               return_state=True)
        return out, pytree.tree_leaves(new)


def _platform_device(platform: str) -> torch.device:
    if platform not in PLATFORMS:
        raise ValueError(f"export: platform {platform!r}; the port exports "
                         f"for {' and '.join(PLATFORMS)}")
    if platform == "cuda":
        from fnssl_tpu_torch.utils.device import resolve_device
        return resolve_device()
    return torch.device("cpu")


def export_model(model: str, module: nn.Module, example_feats, out_dir: str,
                 *, mode: str = "forward",
                 platforms: Sequence[str] | None = None) -> dict:
    """Build and save a serving artifact of ``module`` (the model of
    ``model``, in eval mode).

    mode='forward': exports ``module(feats) -> pred``.
    mode='stream':  exports ``(feats, state) -> (pred, state)`` (the chunk
      step behind ``runtime.streaming``) and saves the initial state for
      ``example_feats``' batch.
    ``platforms``: any of 'cpu' and 'cuda', one program each; None is the
    module's own device type. The module is copied to each other platform.
    """
    if mode not in ("forward", "stream"):
        raise ValueError(f"export: mode {mode!r}")
    platforms = list(platforms or [module.device.type])
    devices = [_platform_device(p) for p in platforms]
    apply_fn, init_state = _resolve(model, module, per_row=False)
    if mode == "stream" and init_state is None:
        raise ValueError(f"{model} has no causal streaming state; export "
                         "with mode='forward'")
    feats0 = torch.as_tensor(np.asarray(example_feats))
    os.makedirs(out_dir, exist_ok=True)
    n_leaves = 0
    for platform, device in zip(platforms, devices):
        m = module if module.device == device else copy.deepcopy(
            module).to(device)
        feats = feats0.to(device)
        spec, args = None, (feats,)
        if mode == "stream":
            _, init_on = _resolve(model, m, per_row=False)
            # one storage a leaf: the models build several state leaves
            # from one zeros tensor
            leaves, spec = pytree.tree_flatten(init_on(feats.shape[0]))
            leaves = [leaf.clone() for leaf in leaves]
            args, n_leaves = (feats, leaves), len(leaves)
            if platform == platforms[0]:
                torch.save([leaf.cpu() for leaf in leaves],
                           os.path.join(out_dir, "init_state.pt"))
        with torch.no_grad():
            program = torch.export.export(_Program(m.eval(), apply_fn, spec),
                                          args)
        torch.export.save(program,
                          os.path.join(out_dir, f"model.{platform}.pt2"))
    meta = {"model": model, "mode": mode,
            "input_shape": list(feats0.shape),
            "input_dtype": str(feats0.dtype).replace("torch.", ""),
            "platforms": platforms, "state_leaves": n_leaves,
            "fnssl_tpu_torch": _pkg_version(), "torch": torch.__version__}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def _pkg_version() -> str:
    import fnssl_tpu_torch

    return getattr(fnssl_tpu_torch, "__version__", "0")


class ServingModel:
    """A loaded artifact: callable without any model code.

    forward mode: ``m(feats) -> pred``.
    stream mode:  ``m(feats) -> pred``, carrying the streaming state across
      calls; ``m.reset()`` restarts the stream.
    Features are moved to the artifact's device; outputs stay there.
    """

    def __init__(self, call: Callable, meta: dict, device: torch.device,
                 init_state: list | None = None):
        self._call = call
        self.meta = meta
        self.device = device
        self._init_state = init_state
        self._state = init_state

    def __call__(self, feats):
        x = torch.as_tensor(feats).to(self.device, torch.float32)
        with torch.no_grad():
            if self.meta["mode"] == "stream":
                out, self._state = self._call(x, self._state)
                return out
            return self._call(x)

    def reset(self):
        self._state = self._init_state

    def clone(self) -> "ServingModel":
        """An independent stream over the same program and weights (fresh
        state): one per served connection."""
        return ServingModel(self._call, self.meta, self.device,
                            self._init_state)


def load_artifact(path: str, device=None) -> ServingModel:
    """Load a directory written by ``export_model`` for ``device`` (None:
    the first CUDA device; its platform must be among the artifact's)."""
    from fnssl_tpu_torch.kernels import ops  # noqa: F401  (registers the ops)
    from fnssl_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if device.type not in meta["platforms"]:
        raise ValueError(f"artifact {path} holds programs for "
                         f"{meta['platforms']}, not {device.type}")
    program = torch.export.load(
        os.path.join(path, f"model.{device.type}.pt2"))
    init_state = None
    if meta["mode"] == "stream":
        init_state = [t.to(device) for t in torch.load(
            os.path.join(path, "init_state.pt"), weights_only=True)]
    return ServingModel(program.module(), meta, device, init_state)
