"""Train/eval steps: optimizer, LR schedule, gradient clipping (port of
``fnssl_tpu/train/step.py``).

Reference parity:
  * FN-SSL: Adam lr 1e-3 with ExponentialLR γ=0.8988 stepped per epoch
    (Lightning/main.py:269-279).
  * IPDnet2: AdamW, grad-clip 5 (run_IPDnet2.py:330-352).

Adam and AdamW take optax's defaults (b1 0.9, b2 0.999, eps 1e-8), which
are torch's; the schedule is a ``LambdaLR`` stepped once per optimizer
step, like optax's count. Clipping by global norm is optax's, not
``clip_grad_norm_`` (which adds 1e-6 to the norm).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class OptimizerSpec(NamedTuple):
    """What ``make_optimizer`` chose; ``init_train_state`` builds it."""
    kind: str
    base_lr: float
    schedule: Callable[[int], float]
    grad_clip: float | None
    weight_decay: float


class TrainState(NamedTuple):
    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int


def exponential_epoch_schedule(base_lr: float, gamma: float,
                               steps_per_epoch: int) -> Callable:
    """lr = base · γ^(count // steps_per_epoch): torch ExponentialLR
    stepped at epoch boundaries, as a function of the update count."""
    def schedule(count: int) -> float:
        return base_lr * gamma ** (count // steps_per_epoch)
    return schedule


def make_optimizer(kind: str = "adam", base_lr: float = 1e-3,
                   gamma: float = 0.8988, steps_per_epoch: int = 1,
                   grad_clip: float | None = None,
                   weight_decay: float = 0.01) -> OptimizerSpec:
    if kind not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {kind!r}")
    return OptimizerSpec(kind, base_lr, exponential_epoch_schedule(
        base_lr, gamma, steps_per_epoch), grad_clip, weight_decay)


def init_train_state(module: torch.nn.Module,
                     tx: OptimizerSpec) -> TrainState:
    params = list(module.parameters())
    if tx.kind == "adam":
        opt = torch.optim.Adam(params, lr=tx.base_lr)
    else:
        opt = torch.optim.AdamW(params, lr=tx.base_lr,
                                weight_decay=tx.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: tx.schedule(count) / tx.base_lr)
    return TrainState(module, opt, sched, 0)


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm in place on the params' grads: unchanged
    when ‖g‖ < max_norm, else (g / ‖g‖) · max_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    divisor = torch.where(keep, torch.ones_like(norm), norm)
    factor = torch.where(keep, torch.ones_like(norm),
                         torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(divisor).mul_(factor)


def make_train_step(loss_fn: Callable, tx: OptimizerSpec):
    """Build the update.

    ``loss_fn(module, batch, generator) -> scalar loss`` holds the whole
    preprocessing + forward + loss. Returns step(state, batch,
    generator=None) → (state, loss): zero the grads, loss, backward, clip,
    optimizer and schedule step.
    """
    def step(state: TrainState, batch, generator=None):
        state.module.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.module, batch, generator)
        loss.backward()
        if tx.grad_clip is not None:
            clip_by_global_norm(state.module.parameters(), tx.grad_clip)
        state.optimizer.step()
        state.scheduler.step()
        return state._replace(step=state.step + 1), loss.detach()

    return step


def make_eval_step(loss_fn: Callable):
    """evaluate(module, batch) → loss, without grads and without dropout."""
    @torch.no_grad()
    def evaluate(module: torch.nn.Module, batch):
        module.eval()
        return loss_fn(module, batch, None)
    return evaluate
