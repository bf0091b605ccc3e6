"""Slot-batched streaming execution: many streams, one device program a
tick (port of ``fnssl_tpu/runtime/slots.py``).

  * a FIXED number of slots S with a handful of static program TIERS (1,
    4, …, S: powers of 4 clamped to S): each tick runs the smallest tier
    covering the active slots, so one connection pays a 1-slot program,
    not an S-slot one;
  * per-slot streaming state lives stacked at full S in static device
    tensors; a new stream's slot is reset and an idle slot's state is
    carried by masks inside the tier (no host-side state surgery);
  * submissions batch opportunistically: the dispatcher waits
    ``batch_window_s`` after the first pending chunk to gather more.

On the card each tier is ONE CUDA graph, the counterpart of JAX's one
compiled program a tier: gather of the tier's slots, masked reset, the
model's chunk step (K1 or K3 among its kernels), masked carry and the
scatter back into the pool's state, all captured once; a tick copies ids,
masks and features into the graph's static buffers and replays it, one
launch whatever the number of streams. ``warmup()`` captures every tier
before traffic, as JAX's compiles every tier; a capture that fails
raises: there is no eager tier on the card. On the CPU (tests,
``--platform cpu``) the same tier function runs eagerly.

The slot axis of every state leaf is found by comparing ``init_state(1)``
with ``init_state(2)``: each leaf scales at exactly one axis, holding
slot-major blocks of rows (row-major flattening of (nb, k, …) in every
model: FN-SSL's (1, nb·nf, H) LSTM states on axis 1, IPDnet's conv tails
(nb, …) and IPDnet2's (nb·16, …) time-module states on axis 0). A leaf
that does not grow with nb is refused: one value shared by slots at
different positions cannot be right for all of them (IPDnet2's MHSA and
retention positions and running scale are kept a row for the pool,
``init_spatialnet_state(per_row=True)``).

A graph replay calls no wrapper, so the kernels' launch counters move
only where a wrapper launched (the capture's eager warm-up, the capture
itself, an eager tier on the CPU); ``replays[s]`` counts a tier's
replays. The kernels a replay ran are read from a device trace.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _slot_axes(init_state_fn) -> list[int]:
    """Per-leaf slot-axis indices, from the shape delta between nb=1 and
    nb=2 states; a leaf that does not scale linearly with nb at exactly
    one axis raises ValueError."""
    s1 = pytree.tree_leaves(init_state_fn(1))
    s2 = pytree.tree_leaves(init_state_fn(2))

    def axis(a, b):
        diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                 if x != y]
        if not diffs:
            raise ValueError(
                f"state leaf {tuple(a.shape)} does not scale with nb: one "
                "value shared by every slot; slot batching unsupported")
        if len(diffs) != 1 or b.shape[diffs[0]] != 2 * a.shape[diffs[0]]:
            raise ValueError(
                f"state leaf {tuple(a.shape)}→{tuple(b.shape)} does not "
                "scale linearly at one axis; slot batching unsupported")
        return diffs[0]

    return [axis(a, b) for a, b in zip(s1, s2)]


def _blocks(leaf: torch.Tensor, ax: int, slots: int) -> torch.Tensor:
    """A view of ``leaf`` with its slot axis split into (slots, k)."""
    shape = leaf.shape
    return leaf.view(shape[:ax] + (slots, shape[ax] // slots)
                     + shape[ax + 1:])


def _per_slot_where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    ax: int, slots: int) -> torch.Tensor:
    """where(mask per slot, a, b) along a leaf's slot axis."""
    av, bv = _blocks(a, ax, slots), _blocks(b, ax, slots)
    m = mask.view((1,) * ax + (slots,) + (1,) * (av.dim() - ax - 1))
    return torch.where(m, av, bv).reshape(a.shape)


def _gather_slots(leaf: torch.Tensor, ids: torch.Tensor, ax: int,
                  slots: int) -> torch.Tensor:
    """Take ``ids``' slot blocks out of a full-pool leaf along its slot
    axis: (…, S·k, …) → (…, s·k, …)."""
    sub = _blocks(leaf, ax, slots).index_select(ax, ids)
    shape = leaf.shape
    return sub.reshape(shape[:ax] + (-1,) + shape[ax + 1:])


def _scatter_slots(full: torch.Tensor, sub: torch.Tensor, ids: torch.Tensor,
                   ax: int, slots: int) -> None:
    """Write ``sub``'s slot blocks into the full-pool leaf at ``ids``, in
    place (the inverse of ``_gather_slots``); ids must be distinct."""
    _blocks(full, ax, slots).index_copy_(
        ax, ids, _blocks(sub, ax, ids.shape[0]))


def _floating(params) -> list[torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        leaves = list(params.parameters())
    else:
        leaves = pytree.tree_leaves(params)
    return [t for t in leaves
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


class _Tier:
    """One tier's CUDA graph and its static inputs and output."""

    def __init__(self, graph, feats, ids, reset, active, out):
        self.graph, self.out = graph, out
        self.feats, self.ids, self.reset, self.active = (feats, ids, reset,
                                                         active)


class SlotBatchedStepper:
    """S-slot batched stateful chunk step with masked reset/carry and
    TIERED program sizes.

    The pool state stays stacked at full S while each tick runs the
    SMALLEST tier s ≥ #active slots:

      sub     = gather(state, ids)                    # (s·k) slot blocks
      sub     = where(reset,  fresh_s, sub)           # new streams
      out, st = apply(params, feats_s, sub)
      sub     = where(active, st,      sub)           # carry padded rows
      state[ids] = sub                                # in place

    Padded rows carry distinct idle slot ids (the scatter needs unique
    indices) with active=False, so their state scatters back unchanged.
    On a CUDA state each tier is captured as one CUDA graph at its first
    use (``BatchedStreamPool.warmup`` captures them all up front); on a
    CPU state the tier runs eagerly.

    Args:
      apply_fn: ``apply_fn(params, feats, state=, return_state=True) ->
        (out, new state)`` (``runtime.export._resolve`` gives one a model).
      params: the weights (an ``nn.Module``, or any tree of them); they
        set the features' upload dtype.
      init_state_fn: ``init_state(nb)`` on the serving device.
    """

    def __init__(self, apply_fn: Callable, params, init_state_fn,
                 slots: int):
        self.slots = slots
        self._axes = _slot_axes(init_state_fn)
        leaves, self._spec = pytree.tree_flatten(init_state_fn(slots))
        # the pool state is scattered into in place: one storage a leaf
        # (the models build several leaves from one zeros tensor)
        self._state = [leaf.clone() for leaf in leaves]
        self._fresh1 = pytree.tree_leaves(init_state_fn(1))
        self.device = self._state[0].device
        self._apply_fn = apply_fn
        self._params = params
        # upload features in the params' dtype where every floating
        # weight is bfloat16 (a bf16 model casts its inputs anyway): half
        # the host→device bytes a tick
        fdts = {t.dtype for t in _floating(params)}
        self._feat_dtype = (torch.bfloat16 if fdts == {torch.bfloat16}
                            else torch.float32)
        self.tier_sizes = []
        s = 1
        while s < slots:
            self.tier_sizes.append(s)
            s *= 4
        self.tier_sizes.append(slots)
        self._tiers: dict[int, _Tier | None] = {}
        self._fresh: dict[int, list] = {}
        self.replays = {s: 0 for s in self.tier_sizes}

    def _run_tier(self, s: int, feats, ids, reset, active):
        """The tier function on the device: gather, masked reset, the
        model step, masked carry, scatter into the pool state in place.
        Returns the tier's output (s·rows, …)."""
        S = self.slots
        if s not in self._fresh:
            self._fresh[s] = [torch.cat([f] * s, dim=ax)
                              for f, ax in zip(self._fresh1, self._axes)]
        with torch.no_grad():
            sub = [_gather_slots(leaf, ids, ax, S)
                   for leaf, ax in zip(self._state, self._axes)]
            sub = [_per_slot_where(reset, fr, st, ax, s)
                   for fr, st, ax in zip(self._fresh[s], sub, self._axes)]
            out, stepped = self._apply_fn(
                self._params, feats,
                state=pytree.tree_unflatten(sub, self._spec),
                return_state=True)
            new = [_per_slot_where(active, n, o, ax, s)
                   for n, o, ax in zip(pytree.tree_leaves(stepped), sub,
                                       self._axes)]
            for full, sb, ax in zip(self._state, new, self._axes):
                _scatter_slots(full, sb, ids, ax, S)
        return out

    def _capture(self, s: int, feats_shape) -> _Tier:
        """Capture tier ``s`` as a CUDA graph: run it once eagerly on a
        side stream with every row inactive (builds the kernels, settles
        their launch attributes and cuDNN's choices; the state scatters
        back unchanged), then capture it. A failed capture raises."""
        dev = self.device
        feats = torch.zeros(feats_shape, dtype=self._feat_dtype, device=dev)
        ids = torch.arange(s, device=dev)
        reset = torch.zeros(s, dtype=torch.bool, device=dev)
        active = torch.zeros(s, dtype=torch.bool, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run_tier(s, feats, ids, reset, active)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._run_tier(s, feats, ids, reset, active)
        return _Tier(graph, feats, ids, reset, active, out)

    def _tier(self, s: int, feats_shape):
        if s not in self._tiers:
            self._tiers[s] = (self._capture(s, feats_shape)
                              if self.device.type == "cuda" else None)
        return self._tiers[s]

    def step_slots(self, ids: np.ndarray, feats, reset_mask: np.ndarray):
        """Run one tick for the ``len(ids)`` active slots.

        feats: (len(ids)·rows, C, nf, k) in ids order (host array or
        tensor). Returns the outputs for exactly those rows (padding
        stripped) on the host."""
        k = len(ids)
        s = next(t for t in self.tier_sizes if t >= k)
        feats = torch.as_tensor(feats).to(self._feat_dtype)
        rows = feats.shape[0] // max(k, 1)
        ids = np.asarray(ids, np.int64)
        reset_mask = np.asarray(reset_mask, bool)
        if s > k:
            taken = set(int(i) for i in ids)
            pad = [i for i in range(self.slots) if i not in taken][:s - k]
            ids = np.concatenate([ids, np.asarray(pad, np.int64)])
            feats = torch.cat([feats, feats.new_zeros(
                ((s - k) * rows,) + tuple(feats.shape[1:]))])
            reset_mask = np.concatenate([reset_mask, np.zeros(s - k, bool)])
        active = np.arange(s) < k
        tier = self._tier(s, tuple(feats.shape))
        self.replays[s] += 1
        if tier is None:
            out = self._run_tier(s, feats.to(self.device),
                                 torch.as_tensor(ids, device=self.device),
                                 torch.as_tensor(reset_mask),
                                 torch.as_tensor(active))
            return out[:k * rows]
        tier.feats.copy_(feats)
        tier.ids.copy_(torch.as_tensor(ids))
        tier.reset.copy_(torch.as_tensor(reset_mask))
        tier.active.copy_(torch.as_tensor(active))
        tier.graph.replay()
        return tier.out[:k * rows].cpu()


class BatchedStreamPool:
    """Connection-facing pool over a SlotBatchedStepper.

    ``session()`` leases a slot and returns a callable usable as a
    StreamingLocalizer ``model_step`` (with ``.close()`` to free the
    slot). Concurrent sessions' chunks ride the SAME tier program.

    Args:
      apply_fn/params/init_state_fn: the model's step family
        (``runtime.export._resolve`` gives these per model name).
      feats_shape: per-stream chunk shape (rows, C, nf, k); rows is the
        pair count P (1 for 2-mic and all-channel models).
      slots: max concurrent streams.
      batch_window_s: the dispatcher's gather bound. A tick fires as soon
        as EVERY leased slot has a pending chunk (no added latency under
        load), else ``batch_window_s`` after the first pending chunk.
    """

    def __init__(self, apply_fn, params, init_state_fn, feats_shape,
                 slots: int = 8, batch_window_s: float = 0.010):
        rows = int(feats_shape[0])
        self.rows, self.slots = rows, slots
        self.stepper = SlotBatchedStepper(
            apply_fn, params, lambda nb: init_state_fn(nb * rows), slots)
        self._feats_shape = tuple(feats_shape)
        self._free = list(range(slots))
        self._needs_reset = np.zeros(slots, bool)
        self._pending: dict[int, tuple[torch.Tensor, Future]] = {}
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._stop = False
        self.window = batch_window_s
        self.ticks = 0
        self.occupancy = 0            # active slots summed over the ticks
        self._thread = threading.Thread(target=self._dispatch,
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ leases

    def session(self):
        with self._lock:
            if not self._free:
                raise RuntimeError(f"all {self.slots} slots leased")
            slot = self._free.pop(0)
            self._needs_reset[slot] = True
        return _SlotSession(self, slot)

    def _release(self, slot: int):
        with self._lock:
            self._free.append(slot)

    def warmup(self, verbose: bool = False):
        """Capture (on the card) or run once (on the CPU) every tier ahead
        of traffic, each with every row inactive, so the state is
        unchanged: a tier's first use otherwise pays its capture inside a
        live request when occupancy first crosses its boundary."""
        import time as _time

        st = self.stepper
        for s in st.tier_sizes:
            t0 = _time.perf_counter()
            shape = (s * self.rows,) + self._feats_shape[1:]
            tier = st._tier(s, shape)
            if tier is None:
                dev = st.device
                st._run_tier(s, torch.zeros(shape, dtype=st._feat_dtype,
                                            device=dev),
                             torch.arange(s, device=dev),
                             torch.zeros(s, dtype=torch.bool),
                             torch.zeros(s, dtype=torch.bool))
            if verbose:
                print(f"slot-pool tier {s} warm: "
                      f"{_time.perf_counter() - t0:.1f}s", flush=True)
        return self

    def close(self):
        self._stop = True
        self._event.set()
        self._thread.join(timeout=5.0)

    # --------------------------------------------------------- dispatch

    def _submit(self, slot: int, feats) -> Future:
        if self._stop:
            raise RuntimeError("pool closed")   # else the future hangs
        fut: Future = Future()
        feats = torch.as_tensor(feats).detach().to("cpu", torch.float32)
        with self._lock:
            if slot in self._pending:
                raise RuntimeError("one in-flight chunk per slot (submit "
                                   "blocks on the result)")
            self._pending[slot] = (feats, fut)
        self._event.set()
        return fut

    def _dispatch(self):
        import time
        while not self._stop:
            if not self._event.wait(timeout=0.2):
                continue
            # gather: fire the moment every leased slot has submitted, else
            # at the window bound
            deadline = time.perf_counter() + self.window
            while not self._stop:
                with self._lock:
                    n_pending = len(self._pending)
                    leased = self.slots - len(self._free)
                if n_pending >= leased or n_pending >= self.slots:
                    break
                if time.perf_counter() >= deadline:
                    break
                time.sleep(0.0005)
            with self._lock:
                if not self._pending:
                    self._event.clear()
                    continue
                batch, self._pending = self._pending, {}
                reset = self._needs_reset.copy()
                for slot in batch:
                    self._needs_reset[slot] = False
                self._event.clear()
            rows = self.rows
            ids = np.fromiter(batch.keys(), np.int64, len(batch))
            feats = torch.cat([fa for fa, _ in batch.values()])
            # reset exactly the slots stepping for the first time this
            # lease; untouched leased slots keep their reset pending
            try:
                out = self.stepper.step_slots(ids, feats, reset[ids])
                self.ticks += 1
                self.occupancy += len(batch)
                for i, (_, fut) in enumerate(batch.values()):
                    fut.set_result(out[i * rows:(i + 1) * rows])
            except Exception as e:               # propagate to callers
                for _, fut in batch.values():
                    fut.set_exception(e)


class _SlotSession:
    """A leased slot: callable chunk step for StreamingLocalizer."""

    def __init__(self, pool: BatchedStreamPool, slot: int):
        self._pool, self._slot = pool, slot
        self._open = True

    def __call__(self, feats):
        if not self._open:
            raise RuntimeError("session closed")
        return self._pool._submit(self._slot, feats).result()

    def close(self):
        if self._open:
            self._open = False
            self._pool._release(self._slot)
