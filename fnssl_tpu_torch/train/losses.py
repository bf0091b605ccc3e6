"""Training losses of FN-SSL (port of ``mse_ipd_loss`` and
``ce_doa_loss`` in ``fnssl_tpu/train/losses.py``; the IPDnet PIT losses
wait for the IPDnet port).

Parity targets: the MSE on pair-unbatched IPD (Lightning/main.py:191-198,
Learner.py:470-487) and the azimuth-class CE (Learner.py:489-496).
"""
from __future__ import annotations

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
