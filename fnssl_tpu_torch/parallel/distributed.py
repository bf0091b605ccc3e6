"""Multi-process initialization and rank-zero helpers (port of
``fnssl_tpu/parallel/distributed.py``).

JAX joins a world with ``jax.distributed.initialize``; here
``torch.distributed.init_process_group`` does, over a rendezvous at the
coordinator (rank 0 hosts the store), with NCCL between cards and gloo on
the CPU. One rank drives one card: NCCL refuses two ranks on one device,
so a CUDA world larger than the host's card count is refused (no quiet
switch to gloo, none to the CPU). Tests and the chip smoke test put two
ranks on one card by asking for gloo explicitly.
"""
from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from fnssl_tpu_torch.parallel.mesh import world

# the rendezvous store of this process's world and its barrier sequence
_STATE: dict = {"store": None, "seq": 0}


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, platform: str = "cuda",
               backend: str | None = None, use_mesh: bool = False,
               timeout_s: float = 900.0) -> torch.device | None:
    """Join the world of ``num_processes`` ranks as rank ``process_id``.

    ``coordinator_address`` is ``HOST:PORT`` (rank 0 listens there) or a
    URL init method (``file:///path``). A no-op returning None for a world
    of one, unless ``use_mesh`` asks for one: it runs in this process with
    an in-process store (no port) and a real all-reduce. ``platform``
    'cuda' pins the rank to ``cuda:(process_id % cards)`` and takes NCCL,
    'cpu' takes gloo; ``backend`` overrides the backend. Returns the
    rank's device.
    """
    size = num_processes or 1
    if size <= 1 and not use_mesh:
        return None
    rank = process_id or 0
    if not 0 <= rank < size:
        raise ValueError(f"process id {rank} is outside a world of {size}")
    backend = backend or ("gloo" if platform == "cpu" else "nccl")
    device = torch.device("cpu")
    if platform != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass platform='cpu' (the "
                               "CLI's --platform cpu) for a gloo world on "
                               "the CPU")
        cards = torch.cuda.device_count()
        if backend == "nccl" and size > cards:
            raise RuntimeError(
                f"a CUDA world of {size} ranks needs {size} cards and this "
                f"host has {cards}: NCCL does not allow two ranks on one "
                "device")
        device = torch.device("cuda", rank % cards)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    timeout = timedelta(seconds=timeout_s)
    if coordinator_address is None:
        if size > 1:
            raise ValueError(f"a world of {size} needs a coordinator "
                             "address")
        store = dist.HashStore()
    else:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        store, rank, size = next(dist.rendezvous(url, rank, size,
                                                 timeout=timeout))
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=size, timeout=timeout)
    _STATE.update(store=store, seq=0)
    return device


def shutdown() -> None:
    """Leave the world (destroys the process group); a no-op outside
    one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(store=None, seq=0)


def is_primary() -> bool:
    """Rank-zero gating for checkpoint/log IO (the reference's
    ``is_global_zero``, Lightning/main.py:138-142)."""
    return world()[0] == 0


def _comm_device() -> torch.device:
    """Where the backend's collectives take their tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sync_global_devices(name: str = "barrier") -> None:
    """A barrier over the process group (a no-op outside one). ``name``
    is kept for JAX's signature."""
    if world()[1] <= 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def coordination_barrier(name: str = "fnssl",
                         timeout_s: float = 900.0) -> None:
    """Align every rank through the rendezvous store, not a collective,
    with the caller's timeout (JAX's coordination-service barrier). A
    no-op on a single process.

    Every rank must call it the same number of times: the barrier ids are
    a process-local sequence, so a rank restarted alone waits at an id its
    peers have passed until the timeout.
    """
    size = world()[1]
    if size <= 1:
        return
    store = _STATE["store"]
    _STATE["seq"] += 1
    key = f"fnssl_barrier/{name}_{_STATE['seq']}"
    if store.add(key, 1) == size:
        store.set(f"{key}/done", "1")
    store.wait([f"{key}/done"], timedelta(seconds=timeout_s))


def broadcast_from_primary(tree):
    """Rank 0's pytree (nested dicts, lists and tuples of tensors, numpy
    arrays and numbers) on every rank: each rank passes a tree of the same
    structure, shapes and dtypes and gets rank 0's values back (tensors on
    their own device). Identity on a single process."""
    if world()[1] <= 1:
        return tree
    comm = _comm_device()

    def leaf(x):
        if isinstance(x, torch.Tensor):
            t = x.detach().to(comm, copy=True).contiguous()
            dist.broadcast(t, src=0)
            return t.to(x.device)
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(x)).to(comm, copy=True)
            dist.broadcast(t, src=0)
            return t.cpu().numpy()
        if isinstance(x, (bool, int, float)):
            dtype = torch.float64 if isinstance(x, float) else torch.int64
            t = torch.tensor(x, dtype=dtype, device=comm)
            dist.broadcast(t, src=0)
            return type(x)(t.item())
        raise TypeError(f"broadcast_from_primary: a leaf of type "
                        f"{type(x).__name__}")

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return leaf(x)

    return walk(tree)


def all_reduce_sum(values: torch.Tensor) -> torch.Tensor:
    """``values`` summed over the ranks, as float64 on the CPU (a copy of
    ``values`` on a single process)."""
    if world()[1] <= 1:
        return values.detach().to("cpu", torch.float64, copy=True)
    t = values.detach().to(_comm_device(), torch.float64, copy=True)
    dist.all_reduce(t)
    return t.cpu()
