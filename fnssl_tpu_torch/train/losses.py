"""Training losses: IPD MSE, DOA cross-entropy and frame-level PIT (port
of ``fnssl_tpu/train/losses.py``).

Parity targets: the MSE on pair-unbatched IPD (Lightning/main.py:191-198,
Learner.py:470-487), the azimuth-class CE (Learner.py:489-496) and
IPDnet's frame-level permutation-invariant MSE over the tracks
(runIPDnetOn.py:196-206), vectorised over all ns! permutations.
"""
from __future__ import annotations

import itertools

import torch

from fnssl_tpu_torch.core.pairs import pair_unbatch


def mse_ipd_loss(pred: torch.Tensor, gt_ipd: torch.Tensor,
                 nb: int) -> torch.Tensor:
    """FN-SSL regression loss.

    Args:
      pred: (nb*P, nt, 2nf) model output (pair dim folded into batch).
      gt_ipd: (nb, nt, 2nf, P) VAD-gated source-summed targets.
    """
    pred = pair_unbatch(pred, nb).permute(0, 2, 3, 1)   # (nb, nt, 2nf, P)
    return ((pred - gt_ipd) ** 2).mean()


def ce_doa_loss(pred_logits: torch.Tensor,
                doa_class: torch.Tensor) -> torch.Tensor:
    """Azimuth-classification loss.

    Args:
      pred_logits: (nb, nt, 180); doa_class: (nb, nt) int class labels.
    """
    logp = torch.log_softmax(pred_logits, dim=-1)
    nll = -torch.gather(logp, -1, doa_class[..., None].long())
    return nll.mean()


def _perm_costs(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(n_perm, nb, nt) MSE over (F, P, ns) of every track permutation of
    ``pred``, in ``itertools.permutations`` order."""
    perms = itertools.permutations(range(pred.shape[-1]))
    return torch.stack([((pred[..., list(p)] - gt) ** 2).mean(dim=(2, 3, 4))
                        for p in perms])


def pit_mse_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Frame-level permutation-invariant MSE over the track axis: for
    every frame, the permutation with the least MSE (the reference's
    torchmetrics PIT with eval_func='min', runIPDnetOn.py:196-206).

    Args:
      pred, gt: (nb, nt, F, P, ns): F = 2·nf features, P mic pairs, ns
        tracks.
    Returns:
      the mean over frames of each frame's best-permutation MSE.
    """
    return _perm_costs(pred, gt).min(dim=0).values.mean()


def pit_permutation(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Each frame's best permutation: (nb, nt) indices into
    ``itertools.permutations(range(ns))``."""
    return _perm_costs(pred, gt).argmin(dim=0)
