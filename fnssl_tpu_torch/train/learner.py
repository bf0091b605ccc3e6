"""Trainer: epoch loops, checkpointing, early stopping (port of
``fnssl_tpu/train/learner.py``).

The reference's training loop (Learner.py:14-355 epoch loops with
Lightning fit/validate/test semantics, SURVEY.md §2.5): one train step
(preprocess + forward + loss + Adam) per batch, ``.tar`` checkpoints with
top-k by valid loss + resume, early stopping, EMA loss display and
TensorBoard/JSONL metrics. Batches reach the card through
``data.loader.prefetch_to_device``. Dropout draws from a
``torch.Generator`` on the device seeded from ``seed`` (JAX's dropout
bits are not reproduced). Losses stay on the device and are fetched in
stacks of up to ``fetch_chunk``; only the live TTY display fetches each
step's loss. The JAX package's host-RSS restart and its stall watchdog
(both work around TPU-client faults) are not carried over.

Data parallelism (JAX's mesh path, ``fnssl_tpu/train/learner.py``): when
a ``torch.distributed`` process group is up, the module runs under
``DistributedDataParallel``, which averages the gradients over the ranks
(with equal shards, the update on the global batch). The losses that
decide anything are all-reduced: the train losses at each stacked fetch
(every rank fetches them stacked, whether or not its stdout is a TTY, so
every rank reaches each all-reduce at the same step) and the valid
loss's weighted sum and count, so every rank logs, early-stops and ranks
checkpoints on the same numbers. Eval metrics stay the rank's own, as in
JAX. Rank 0 writes the checkpoints (the unwrapped module's state dict)
and ``best_model.tar``; rank K > 0 logs to ``<log_dir>/rankK/`` without
TensorBoard. Dropout draws from ``seed + rank``.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from fnssl_tpu_torch.data.loader import prefetch_to_device
from fnssl_tpu_torch.parallel.distributed import (all_reduce_sum,
                                                  sync_global_devices)
from fnssl_tpu_torch.parallel.mesh import data_parallel, unwrap, world
from fnssl_tpu_torch.train.checkpoint import CheckpointManager
from fnssl_tpu_torch.train.convert import load_torch_tar
from fnssl_tpu_torch.train.step import (
    init_train_state, make_eval_step, make_optimizer, make_train_step)
from fnssl_tpu_torch.utils.device import resolve_device
from fnssl_tpu_torch.utils.logging import (
    EmaLoss, MetricLogger, ProgressLine, detect_infnan)


class EarlyStopping:
    """Stop after ``patience`` epochs without ``min_delta`` improvement
    (Lightning/main.py:290-296). ``patience <= 0`` disables stopping."""

    def __init__(self, patience: int = 10, min_delta: float = 0.01):
        self.patience = patience
        self.min_delta = min_delta
        self.best = np.inf
        self.bad_epochs = 0

    def update(self, value: float) -> bool:
        """Returns True when training should stop."""
        if value < self.best - self.min_delta:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return self.patience > 0 and self.bad_epochs >= self.patience


class Learner:
    """Trains ``module`` with ``loss_fn(module, batch, generator)`` on
    ``device`` (the first CUDA device unless given; the module is moved
    there).

    ``metric_fn(pred, batch) -> dict`` scores each eval batch from the
    module's output of that batch's eval step (caught by a forward hook),
    so an eval batch runs the model once.
    """

    def __init__(self, loss_fn: Callable, module: torch.nn.Module, *,
                 optimizer: str = "adam", lr: float = 1e-3,
                 lr_gamma: float = 0.8988, grad_clip: float | None = None,
                 steps_per_epoch: int = 1, log_dir: str = "runs/default",
                 keep_top_k: int = 5, metric_fn: Callable | None = None,
                 early_stopping: EarlyStopping | None = None,
                 seed: int = 2, device=None):
        self.device = resolve_device(device)
        self.tx = make_optimizer(optimizer, lr, lr_gamma, steps_per_epoch,
                                 grad_clip)
        self.rank, self.world = world()
        module = module.to(self.device)
        if torch.distributed.is_initialized():
            module = data_parallel(module)
        self.state = init_train_state(module, self.tx)
        self.train_step = make_train_step(loss_fn, self.tx)
        self.eval_step = make_eval_step(loss_fn)
        self.logger = MetricLogger(
            log_dir if self.rank == 0
            else os.path.join(log_dir, f"rank{self.rank}"),
            use_tensorboard=self.rank == 0)
        self.best_path = os.path.join(log_dir, "best_model.tar")
        self.ckpt = CheckpointManager(os.path.join(log_dir, "ckpt"),
                                      keep_top_k=keep_top_k,
                                      best_path=self.best_path)
        self.metric_fn = metric_fn
        self.early_stopping = early_stopping or EarlyStopping()
        self.epoch = 0
        # deferred-loss flush interval: bounds live device buffers in
        # long epochs (the reference's epochs reach ~10k steps)
        self.fetch_chunk = 512
        self.prefetch = 2
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + self.rank)

    def _on_device(self, batches):
        return prefetch_to_device(batches, self.prefetch, self.device)

    def resume(self, best: bool = False):
        """Restore the latest checkpoint if one exists. ``best=True``
        restores the epoch with the lowest valid loss instead (the
        reference's best_model.tar selection, Learner.py:343-353), or,
        where ``ckpt/`` holds none, the weights of
        ``<log_dir>/best_model.tar``."""
        epoch = self.ckpt.best_epoch() if best else None
        restored, step = self.ckpt.restore(self.state, epoch=epoch)
        if restored is None and best and os.path.exists(self.best_path):
            state_dict, meta = load_torch_tar(self.best_path)
            unwrap(self.state.module).load_state_dict(state_dict, strict=True)
            restored, step = self.state, int(meta.get("epoch", 0))
        if restored is not None:
            self.state = restored
            self.epoch = int(step) + 1
            print(f"resumed from epoch {step}")
        return self.epoch

    def train_epoch(self, batches: Iterable) -> float:
        """One epoch of train steps. Logs the EMA loss, the epoch's
        seconds, its steps, the seconds the loop waited on the loader and,
        of those, the wait for the first batch (``train/loss``,
        ``train/epoch_s``, ``train/steps``, ``train/loader_wait_s``,
        ``train/first_batch_wait_s``)."""
        ema = EmaLoss()
        last = 0.0
        t0 = time.perf_counter()
        progress = ProgressLine(
            self.epoch, total=len(batches) if hasattr(batches, "__len__")
            else None)
        # Interactive runs fetch each loss for the live display; batch
        # runs keep the losses on the device and fetch them stacked, so
        # the host never waits for a step to finish before queuing the
        # next one. Under data parallelism every rank fetches stacked and
        # all-reduces each stack (the live display shows the rank's own
        # losses).
        live = progress.visible
        deferred = not live or self.world > 1
        pending: list = []
        host_vals: list[float] = []
        steps, waited, first_wait = 0, 0.0, None

        def _flush():
            if pending:
                summed = all_reduce_sum(torch.stack(pending).float())
                host_vals.extend((summed / self.world).tolist())
                pending.clear()

        stream = iter(self._on_device(batches))
        while True:
            tw = time.perf_counter()
            batch = next(stream, None)
            waited += time.perf_counter() - tw
            if first_wait is None:
                first_wait = waited
            if batch is None:
                break
            self.state, loss = self.train_step(self.state, batch,
                                               self.generator)
            steps += 1
            if live:
                last = ema.update(float(loss))
                progress.update(last)
            if deferred:
                pending.append(loss)
                if len(pending) >= self.fetch_chunk:
                    _flush()
        progress.close()
        _flush()
        if deferred:
            ema = EmaLoss()
            for v in host_vals:
                last = ema.update(v)
        epoch_s = time.perf_counter() - t0
        self.logger.log("train/loss", last, self.epoch)
        self.logger.log("train/epoch_s", epoch_s, self.epoch)
        self.logger.log("train/steps", steps, self.epoch)
        self.logger.log("train/loader_wait_s", waited, self.epoch)
        self.logger.log("train/first_batch_wait_s", first_wait, self.epoch)
        return last

    def eval_epoch(self, batches: Iterable, split: str = "valid"
                   ) -> dict[str, float]:
        # Per-sample weighting: a ragged last batch must not bias the
        # epoch mean (the reference accumulates per-sample; this number
        # drives top-k checkpoint ranking).
        dev_losses, weights, metrics_acc = [], [], []
        caught = {}
        hook = None
        if self.metric_fn is not None:
            hook = self.state.module.register_forward_hook(
                lambda module, args, out: caught.update(pred=out))
        try:
            for batch in self._on_device(batches):
                dev_losses.append(self.eval_step(self.state.module, batch))
                weights.append(float(len(batch["mic_sig"])))
                if self.metric_fn is not None:
                    metrics_acc.append(self.metric_fn(caught.pop("pred"),
                                                      batch))
        finally:
            if hook is not None:
                hook.remove()
        if not dev_losses:
            return {"loss": float("nan")}
        fetched = torch.stack(dev_losses).float().cpu().numpy()
        keep = [i for i, v in enumerate(fetched)
                if not detect_infnan(float(v), f"{split}/loss")]
        losses = fetched[keep]
        w = np.asarray(weights)[keep]
        # the weighted sum and count over the world's batches (every rank
        # reaches the all-reduce, diverged batches or not)
        total, count = all_reduce_sum(torch.tensor(
            [np.sum(losses * w), np.sum(w)], dtype=torch.float64)).tolist()
        if not count:
            # Every batch diverged: report NaN and keep training (the
            # filtering exists to survive divergence, not crash on it).
            return {"loss": float("nan")}
        metrics_acc = ([metrics_acc[i] for i in keep] if metrics_acc
                       else metrics_acc)
        out = {"loss": total / count}
        if metrics_acc:
            for k in metrics_acc[0]:
                # metric values may be vectors (e.g. multi-entry ae_mode):
                # average along the batch axis only, fold scalars to float
                avg = np.average(
                    np.asarray([m[k] for m in metrics_acc], np.float64),
                    axis=0, weights=w)
                out[k] = float(avg) if avg.ndim == 0 else avg.tolist()
        self.logger.log_dict(out, self.epoch, prefix=f"{split}/")
        return out

    def fit(self, train_batches_fn: Callable[[int], Iterable],
            valid_batches_fn: Callable[[int], Iterable],
            epochs: int = 100, valid_every: int = 1) -> dict:
        """Full training: per-epoch train + validate + checkpoint + early
        stop. ``*_batches_fn(epoch)`` returns that epoch's batch iterable
        (deterministic per-epoch shuffling hooks in here).

        Preemption-safe (SURVEY §5.3): SIGTERM/SIGINT request a graceful
        stop at the next epoch boundary, where the state is checkpointed
        so ``resume()`` continues exactly.

        ``valid_every`` validates (and checkpoints) every N epochs
        instead of every epoch, for many-tiny-epoch regimes. The final
        epoch and an interrupt always validate + checkpoint, so
        resume/early-stop semantics hold; early stopping counts only
        validated epochs.
        """
        import signal

        interrupted = {"flag": False}

        def _request_stop(signum, frame):
            print(f"signal {signum}: checkpointing at epoch boundary")
            interrupted["flag"] = True

        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, _request_stop)
            except ValueError:  # non-main thread
                pass

        history = {"train": [], "valid": []}
        try:
            while self.epoch < epochs:
                train_loss = self.train_epoch(train_batches_fn(self.epoch))
                history["train"].append(train_loss)
                # a signal on any rank stops every rank at this epoch
                interrupted["flag"] = bool(all_reduce_sum(
                    torch.tensor([float(interrupted["flag"])]))[0])
                do_valid = (valid_every <= 1
                            or (self.epoch + 1) % valid_every == 0
                            or self.epoch + 1 >= epochs
                            or interrupted["flag"])
                stop = False
                if do_valid:
                    valid = self.eval_epoch(valid_batches_fn(self.epoch))
                    history["valid"].append(valid["loss"])
                    # a fully-diverged (NaN) epoch must never rank best
                    self.ckpt.save(self.epoch, self.state,
                                   valid["loss"]
                                   if np.isfinite(valid["loss"])
                                   else float("inf"))
                    sync_global_devices("ckpt")
                    stop = self.early_stopping.update(valid["loss"])
                    print(f"epoch {self.epoch}: train {train_loss:.5f} "
                          f"valid {valid['loss']:.5f}"
                          + (" [early stop]" if stop else ""))
                else:
                    print(f"epoch {self.epoch}: train {train_loss:.5f}")
                self.epoch += 1
                if stop or interrupted["flag"]:
                    break
        finally:
            for sig, handler in prev.items():
                signal.signal(sig, handler)
        return history

    def write_flops(self, example, **kw):
        """FLOPs.yaml into the run dir (the reference's on_train_start
        write_FLOPs hook, Lightning/main.py:146-147), counted on the
        unwrapped module with ``example`` as its input."""
        from fnssl_tpu_torch.utils.flops import write_flops

        return write_flops(unwrap(self.state.module), example,
                           self.logger.log_dir, **kw)

    def test(self, batches: Iterable) -> dict[str, float]:
        return self.eval_epoch(batches, split="test")

    def close(self):
        self.logger.close()
