"""Data and frequency parallelism (port of ``fnssl_tpu/parallel``):
per-rank schedules and batch rows, the module under DDP, the 2-D
(data × freq) mesh and the multi-process runtime.

JAX's names and their counterparts: ``make_mesh``, ``batch_sharding`` and
``replicated_sharding`` → ``data_parallel`` (one process per card, the
module under ``DistributedDataParallel``); ``make_mesh_2d`` (a ``Mesh2D``
of process groups) and ``freq_sharded_input`` (the rank's block of a
global input), whose collectives are ``parallel/freq.py``'s;
``shard_batch``, ``replicate_params``, ``host_local_slice``,
``initialize``, ``is_primary``, ``sync_global_devices`` and
``broadcast_from_primary`` under their own names.
"""
from fnssl_tpu_torch.parallel.mesh import (
    FREQ_AXIS, Mesh2D, data_parallel, freq_sharded_input, make_mesh_2d,
    shard_batch, replicate_params, host_local_slice, unwrap, world)
from fnssl_tpu_torch.parallel.distributed import (
    initialize, is_primary, sync_global_devices, broadcast_from_primary,
    coordination_barrier, shutdown)
