"""Epoch checkpoints with the reference's policy (port of
``fnssl_tpu/train/checkpoint.py``, whose orbax manager needs JAX).

Policy (SURVEY.md §5.4, Lightning ModelCheckpoint top-5 on valid/loss +
save_last, Lightning/main.py:298-308): each validated epoch is saved; the
``keep_top_k`` epochs with the lowest valid loss and the latest epoch are
kept, the rest deleted. A NaN valid loss ranks as +inf.

Layout under ``directory``: ``epoch_<e>.tar`` (``torch.save`` of the
model's state dict, the optimizer's and the scheduler's state, the step,
the epoch and its valid loss, all on the CPU) and ``index.json`` (kept
epoch → valid loss). Every file is written to a temporary name, then
``os.replace``-d. With ``best_path``, the best epoch's weights are also
written there in the reference ``.tar`` format
(``train.convert.save_torch_tar``), the file ``cli serve`` reads. The
model's state dict is the unwrapped module's (no DDP ``module.``
prefix). Under data parallelism every rank keeps the index and rank 0
alone (``parallel.is_primary``) writes and deletes the files.
"""
from __future__ import annotations

import json
import math
import os

import torch

from fnssl_tpu_torch.parallel.distributed import is_primary
from fnssl_tpu_torch.parallel.mesh import unwrap
from fnssl_tpu_torch.train.convert import save_torch_tar
from fnssl_tpu_torch.train.step import TrainState


def _cpu(obj):
    """Tensors anywhere in nested dicts/lists moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _replace_into(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Epoch-keyed ``.tar`` checkpoints: top-k by valid loss + last."""

    def __init__(self, directory: str, keep_top_k: int = 5,
                 best_path: str | None = None):
        self.directory = os.path.abspath(directory)
        self.keep_top_k = keep_top_k
        self.best_path = best_path
        os.makedirs(self.directory, exist_ok=True)
        self._index: dict[int, float] = {}
        index = os.path.join(self.directory, "index.json")
        if os.path.exists(index):
            with open(index) as f:
                self._index = {int(k): float(v)
                               for k, v in json.load(f).items()}

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.tar")

    @staticmethod
    def _rank(item):
        epoch, loss = item
        return (math.inf if math.isnan(loss) else loss, epoch)

    def save(self, epoch: int, state: TrainState, valid_loss: float):
        self._index[epoch] = float(valid_loss)
        ranked = sorted(self._index.items(), key=self._rank)
        keep = {e for e, _ in ranked[:self.keep_top_k]} | {max(self._index)}
        dropped = set(self._index) - keep
        for e in dropped:
            del self._index[e]
        if not is_primary():
            return
        payload = {"epoch": epoch, "valid_loss": float(valid_loss),
                   "step": state.step,
                   "model": _cpu(unwrap(state.module).state_dict()),
                   "optimizer": _cpu(state.optimizer.state_dict()),
                   "scheduler": state.scheduler.state_dict()}
        _replace_into(self.path(epoch), lambda p: torch.save(payload, p))
        for e in dropped:
            if os.path.exists(self.path(e)):
                os.remove(self.path(e))

        def write_index(p):
            with open(p, "w") as f:
                json.dump({str(k): v for k, v in self._index.items()}, f)

        _replace_into(os.path.join(self.directory, "index.json"),
                      write_index)
        if self.best_path is not None and self.best_epoch() == epoch:
            _replace_into(self.best_path, lambda p: save_torch_tar(
                p, payload["model"], epoch=epoch))

    def latest_epoch(self) -> int | None:
        return max(self._index) if self._index else None

    def best_epoch(self) -> int | None:
        """The kept epoch with the lowest valid loss (the earliest on a
        tie)."""
        if not self._index:
            return None
        return min(self._index.items(), key=self._rank)[0]

    def load_weights(self, module, epoch: int | None = None):
        """Load the latest (or the given) epoch's model weights into
        ``module`` alone (serving and export). Returns the epoch, or None
        when there is no checkpoint."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            return None
        payload = torch.load(self.path(epoch), map_location="cpu",
                             weights_only=False)
        module.load_state_dict(payload["model"], strict=True)
        return epoch

    def restore(self, state: TrainState, epoch: int | None = None):
        """Load the latest (or the given) epoch into ``state``'s module,
        optimizer and scheduler. Returns (state, epoch), or (None, None)
        when there is no checkpoint."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            return None, None
        payload = torch.load(self.path(epoch), map_location="cpu",
                             weights_only=False)
        unwrap(state.module).load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.scheduler.load_state_dict(payload["scheduler"])
        return state._replace(step=payload["step"]), epoch
