"""Per-epoch batch schedules (port of ``host_local_slice`` from
``fnssl_tpu/parallel/mesh.py``). The port runs one process, rank 0 of a
world of 1, so the schedule takes every item; the sharding across
processes waits for the data-parallel port."""
from __future__ import annotations

import numpy as np


def host_local_slice(num_items: int, epoch: int, seed: int = 2,
                     shuffle: bool = True) -> list[tuple[int, int]]:
    """Deterministic (index, item_seed) schedule of one epoch.

    MyDistributedSampler semantics (IPDnet2/sampler.py:20-97) for rank 0
    of 1: the epoch-seeded permutation (or the identity without
    ``shuffle``), each index paired with a per-item seed so on-the-fly
    augmentation is reproducible across resumes. The JAX package's
    schedule for rank 0 of 1, draw for draw.
    """
    g = np.random.default_rng(seed + epoch)
    order = (g.permutation(num_items) if shuffle
             else np.arange(num_items))
    item_seeds = g.integers(0, 2 ** 31 - 1, size=num_items)
    return [(int(i), int(s)) for i, s in zip(order, item_seeds)]
