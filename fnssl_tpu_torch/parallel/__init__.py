"""Data parallelism (port of ``fnssl_tpu/parallel``): per-rank schedules
and batch rows, the module under DDP, and the multi-process runtime.

JAX's names and their counterparts: ``make_mesh``, ``batch_sharding`` and
``replicated_sharding`` → ``data_parallel`` (one process per card, the
module under ``DistributedDataParallel``); ``shard_batch``,
``replicate_params``, ``host_local_slice``, ``initialize``,
``is_primary``, ``sync_global_devices`` and ``broadcast_from_primary``
under their own names. ``make_mesh_2d`` and ``freq_sharded_input`` (the
data × frequency mesh) are not ported.
"""
from fnssl_tpu_torch.parallel.mesh import (
    data_parallel, shard_batch, replicate_params, host_local_slice, unwrap,
    world)
from fnssl_tpu_torch.parallel.distributed import (
    initialize, is_primary, sync_global_devices, broadcast_from_primary,
    coordination_barrier, shutdown)
