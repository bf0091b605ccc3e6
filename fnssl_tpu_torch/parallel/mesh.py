"""Data parallelism over processes, and the 2-D data × frequency mesh
(port of ``fnssl_tpu/parallel/mesh.py``).

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

  ``make_mesh_2d`` → ``make_mesh_2d`` (a ``Mesh2D``: this rank's
      (data, freq) coordinates and the process groups of its row and
      column of the mesh)
  ``freq_sharded_input`` → ``freq_sharded_input`` (this rank's block of a
      global (nb, C, nf, nt) input)

Over a 2-D mesh the model's forward takes the mesh
(``SpatialNet.forward(x, freq_mesh=mesh)``) and runs the collectives that
XLA's partitioner inserts from ``parallel/freq.py``;
``train.step.make_train_step(..., mesh=mesh)`` averages the gradients over
the mesh's whole world.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
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
                process_count: int | None = None, *,
                mesh: "Mesh2D | None" = None) -> dict[str, Any]:
    """The rank's contiguous block of rows of every leaf of a global batch
    (rank r of w takes rows [r·n/w, (r+1)·n/w), the block of the data axis
    JAX's batch sharding gives device r). Refuses a batch the world does
    not divide. With a 2-D ``mesh`` the rows are those of the rank's data
    index among ``n_data`` (the ranks of one data index share them): the
    process group's rank and size would count the freq axis too."""
    if mesh is not None:
        process_index, process_count = mesh.data_index, mesh.n_data
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


DATA_AXIS, FREQ_AXIS = "data", "freq"


@dataclass(frozen=True)
class Mesh2D:
    """This rank's place on a (data × freq) mesh of processes (JAX's 2-D
    ``Mesh``). Ranks are laid out row-major, rank = d · n_freq + f, as
    JAX's ``devices.reshape(n_data, n_freq)``. ``freq_group`` holds the
    ranks of this rank's data index (its row: they share batch rows and
    split the frequencies), ``data_group`` those of its freq index (its
    column); both are None on a mesh of one process."""
    axis_names: tuple[str, str]
    n_data: int
    n_freq: int
    data_index: int
    freq_index: int
    freq_group: Any = None
    data_group: Any = None

    @property
    def size(self) -> int:
        return self.n_data * self.n_freq


def make_mesh_2d(n_data: int, n_freq: int,
                 axis_names: tuple[str, str] = (DATA_AXIS, FREQ_AXIS)
                 ) -> Mesh2D:
    """The (n_data × n_freq) mesh over the process group's world, which
    must hold exactly n_data · n_freq ranks (1 × 1 works without a
    group). Every rank creates every row's and column's group, in the
    same order (``new_group`` is collective), and keeps its own two."""
    if n_data < 1 or n_freq < 1:
        raise ValueError(f"a mesh of {n_data} x {n_freq}")
    rank, size = world()
    if size != n_data * n_freq:
        raise ValueError(f"a {n_data} x {n_freq} mesh needs a world of "
                         f"{n_data * n_freq} ranks; this one has {size}")
    d, f = divmod(rank, n_freq)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh2D(tuple(axis_names), n_data, n_freq, d, f)
    rows = [dist.new_group([i * n_freq + j for j in range(n_freq)])
            for i in range(n_data)]
    cols = [dist.new_group([i * n_freq + j for i in range(n_data)])
            for j in range(n_freq)]
    return Mesh2D(tuple(axis_names), n_data, n_freq, d, f, rows[d], cols[f])


def freq_sharded_input(mesh: Mesh2D, x):
    """This rank's block (nb/n_data, C, nf/n_freq, nt) of a global
    (nb, C, nf, nt) network input: rows of its data index, bins of its
    freq index (the block JAX's ``P('data', None, 'freq', None)`` places
    on its device). Refuses an input the mesh does not divide."""
    nb, nf = x.shape[0], x.shape[2]
    if nb % mesh.n_data or nf % mesh.n_freq:
        raise ValueError(f"an input of {nb} rows and {nf} bins does not "
                         f"split over a {mesh.n_data} x {mesh.n_freq} mesh")
    b, f = nb // mesh.n_data, nf // mesh.n_freq
    return x[mesh.data_index * b:(mesh.data_index + 1) * b, :,
             mesh.freq_index * f:(mesh.freq_index + 1) * f]
