"""Input-pipeline overlap: prefetching batch loader + device prefetch (port
of ``fnssl_tpu/data/loader.py``).

The reference feeds every trainer from ``torch.utils.data.DataLoader(...,
num_workers=N)`` (FN-SSL/Train.py:94-101): batch assembly overlaps the
device's compute. Two composable pieces do that here:

  * ``DataLoader`` — the JAX package's loader, verbatim: batches are
    assembled on a thread pool, ``prefetch`` batches ahead of the
    consumer, and yielded in schedule order (worker completion order
    never leaks into batch order). The hot host work (the C++/OpenMP ISM
    engine, file reads, large numpy ops) releases the GIL.
  * ``prefetch_to_device`` — copies ready batches to the card ``size``
    steps ahead from pinned host memory on a side CUDA stream, so the
    host→device copy of batch t+1 runs under the step at t.
"""
from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Sequence

import torch

from fnssl_tpu_torch.utils.device import resolve_device


class DataLoader:
    """Deterministic prefetching batch loader.

    Args:
      fetch: ``fetch(entry) -> sample`` — called once per schedule entry
        (an index, or whatever ``schedule`` holds, e.g. the
        ``(index, seed)`` pairs of ``host_local_slice``).
      schedule: this epoch's ordered entries (already sharded/shuffled).
      batch_size: samples per batch.
      collate: ``collate([samples]) -> batch``.
      num_workers: assembly threads; 0 = fully serial (no queue, no
        threads — bit-identical control flow to a python loop).
      prefetch: batches kept in flight beyond the one being consumed.
      drop_last: drop a ragged final batch (the reference's fixed-shape
        training contract; keep it for eval so no sample is lost).

    Iterating yields batches in schedule order; any worker exception is
    re-raised at the consumer at that batch's position.
    """

    def __init__(self, fetch: Callable, schedule: Sequence,
                 batch_size: int, collate: Callable, *,
                 num_workers: int = 2, prefetch: int = 2,
                 drop_last: bool = True):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.fetch = fetch
        self.schedule = list(schedule)
        self.batch_size = batch_size
        self.collate = collate
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last

    def _batch_entries(self):
        bz = self.batch_size
        end = len(self.schedule) - (bz - 1 if self.drop_last else 0)
        for i in range(0, max(end, 0), bz):
            yield self.schedule[i:i + bz]

    def _assemble(self, entries):
        return self.collate([self.fetch(e) for e in entries])

    def __len__(self) -> int:
        n, bz = len(self.schedule), self.batch_size
        return n // bz if self.drop_last else -(-n // bz)

    def __iter__(self) -> Iterator:
        if self.num_workers <= 0:
            for entries in self._batch_entries():
                yield self._assemble(entries)
            return
        # Submission order == yield order: determinism by construction.
        pool = ThreadPoolExecutor(self.num_workers)
        pending = collections.deque()
        entry_iter = self._batch_entries()
        try:
            for entries in entry_iter:
                pending.append(pool.submit(self._assemble, entries))
                if len(pending) > self.prefetch:
                    break
            while pending:
                batch = pending.popleft().result()
                nxt = next(entry_iter, None)
                if nxt is not None:
                    pending.append(pool.submit(self._assemble, nxt))
                yield batch
            pool.shutdown(wait=True)
        finally:
            # Consumer bailed early (break / KeyboardInterrupt): drop
            # queued work and do NOT wait for in-flight assemblies —
            # an on-the-fly ISM fetch can hold the pool for seconds.
            pool.shutdown(wait=False, cancel_futures=True)


def prefetch_to_device(batches: Iterable, size: int = 2,
                       device=None) -> Iterator:
    """Yield each batch (a dict of arrays) as tensors on the CUDA
    ``device`` (None: the first CUDA device, as every entry point of the
    port; it raises here where there is none), with the copies of up to
    ``size`` later batches already under way.

    On a CUDA device each array goes to pinned host memory, then to the
    card with a ``non_blocking`` copy on a side stream, and an event
    marks the end of the batch's copies. Before a batch is yielded the
    compute stream waits on that event (so no kernel reads a batch before
    its copy has landed), and each tensor is ``record_stream``-ed on the
    compute stream (so the caching allocator does not hand its memory to
    a later copy while the step still reads it). On the CPU the batches
    pass through as they are.

    As in the JAX package, the first batch is yielded only once ``size +
    1`` batches have been taken from ``batches``, so the first step of an
    epoch waits for that many batch assemblies; later steps find theirs
    assembled under the steps before.
    """
    return _prefetch(batches, size, resolve_device(device))


def _prefetch(batches: Iterable, size: int, device: torch.device
              ) -> Iterator:
    if device.type != "cuda":
        yield from batches
        return
    side = torch.cuda.Stream(device)
    queue = collections.deque()

    def put(b):
        with torch.cuda.stream(side):
            out = {k: torch.as_tensor(v).pin_memory().to(
                       device, non_blocking=True) for k, v in b.items()}
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def ready(item):
        out, done = item
        compute = torch.cuda.current_stream(device)
        compute.wait_event(done)
        for t in out.values():
            t.record_stream(compute)
        return out

    for b in batches:
        queue.append(put(b))
        if len(queue) > size:
            yield ready(queue.popleft())
    while queue:
        yield ready(queue.popleft())
