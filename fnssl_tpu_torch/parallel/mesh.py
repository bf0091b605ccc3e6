"""Data parallelism over processes (port of the 1-D half of
``fnssl_tpu/parallel/mesh.py``).

The reference's distributed story is data parallelism over NCCL (torch
DDP, SURVEY.md §2.9). JAX expresses it as a 1-D mesh over the ``data``
axis: the batch sharded, the parameters replicated, the gradient psum
inserted by XLA. The torch idiom is one process per card, each holding a
replica and its rows of the global batch, with
``DistributedDataParallel`` all-reducing the gradients during the
backward. The JAX names and their counterparts here:

  ``make_mesh`` + ``batch_sharding`` + ``replicated_sharding``
      → ``data_parallel`` (the module under DDP on the rank's device)
  ``replicate_params`` → ``replicate_params`` (rank 0's module state
      broadcast in place)
  ``shard_batch`` → ``shard_batch`` (a rank's rows of the global batch:
      the process-local contract of JAX's multi-process ``shard_batch``)
  ``host_local_slice`` → ``host_local_slice`` (the same schedule, draw for
      draw)

``make_mesh_2d`` and ``freq_sharded_input`` (model parallelism over
frequency) are not ported.
"""
from __future__ import annotations

import inspect
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist


def world() -> tuple[int, int]:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_local_slice(num_items: int, epoch: int, seed: int = 2,
                     process_index: int | None = None,
                     process_count: int | None = None,
                     shuffle: bool = True) -> list[tuple[int, int]]:
    """Deterministic per-rank (index, item_seed) schedule of one epoch.

    MyDistributedSampler semantics (IPDnet2/sampler.py:20-97): every rank
    derives the same epoch-seeded permutation (the identity without
    ``shuffle``), pads it by wrapping to a multiple of the world, takes a
    strided slice and pairs each index with a per-item seed, so on-the-fly
    augmentation is reproducible across ranks and resumes. Rank and world
    default to the process group's (0 of 1 without one). The JAX
    package's schedule, draw for draw.
    """
    rank, size = world()
    rank = rank if process_index is None else process_index
    size = size if process_count is None else process_count
    g = np.random.default_rng(seed + epoch)
    order = (g.permutation(num_items) if shuffle
             else np.arange(num_items))
    item_seeds = g.integers(0, 2 ** 31 - 1, size=num_items)
    total = -(-num_items // size) * size
    if total > num_items:  # pad by wrapping, like DistributedSampler
        pad = total - num_items
        order = np.concatenate([order, order[:pad]])
        item_seeds = np.concatenate([item_seeds, item_seeds[:pad]])
    return [(int(order[i]), int(item_seeds[i]))
            for i in range(rank, total, size)]


def shard_batch(batch: Mapping[str, Any], process_index: int | None = None,
                process_count: int | None = None) -> dict[str, Any]:
    """The rank's contiguous block of rows of every leaf of a global batch
    (rank r of w takes rows [r·n/w, (r+1)·n/w), the block of the data axis
    JAX's batch sharding gives device r). Refuses a batch the world does
    not divide."""
    rank, size = world()
    rank = rank if process_index is None else process_index
    size = size if process_count is None else process_count
    n = len(next(iter(batch.values())))
    if n % size:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{size} ranks")
    rows = slice(rank * n // size, (rank + 1) * n // size)
    return {k: v[rows] for k, v in batch.items()}


@torch.no_grad()
def replicate_params(module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers broadcast into every rank's
    ``module`` in place (a no-op without a process group)."""
    if world()[1] > 1:
        for t in unwrap(module).state_dict().values():
            dist.broadcast(t, src=0)
    return module


def data_parallel(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` (already on the rank's device) under
    ``DistributedDataParallel``: rank 0's state is broadcast at
    construction, and every backward all-reduces and averages the
    gradients, so with equal shards an update equals the single-process
    update on the global batch. Buffers are not re-broadcast each forward
    (no train path keeps running statistics)."""
    ddp = torch.nn.parallel.DistributedDataParallel
    # torch >= 2.13 names the option forward_sync_buffers
    sync = ("forward_sync_buffers"
            if "forward_sync_buffers" in inspect.signature(ddp).parameters
            else "broadcast_buffers")
    device = next(module.parameters()).device
    return ddp(module, device_ids=[device] if device.type == "cuda" else None,
               **{sync: False})


def unwrap(module: torch.nn.Module) -> torch.nn.Module:
    """The module inside a DDP wrapper (``module`` itself otherwise): its
    state dict has no ``module.`` prefix."""
    if isinstance(module, torch.nn.parallel.DistributedDataParallel):
        return module.module
    return module
