"""FN-SSL training-target assembly (port of ``ipd_complex_to_ri`` and
``vad_mask_and_sum`` in ``fnssl_tpu/physics/targets.py``): the
reference's single-source masking (Lightning/main.py:237-259) as two
vectorised ops."""
from __future__ import annotations

import torch


def ipd_complex_to_ri(ipd: torch.Tensor, fre_used) -> torch.Tensor:
    """(nb, nt, nf, P, ns) complex → (nb, nt, 2nf_used, P, ns) float32:
    the used bins' real then imaginary parts along the frequency axis."""
    sel = ipd[:, :, fre_used]
    return torch.cat([sel.real, sel.imag], dim=2).float()


def vad_mask_and_sum(ipd_ri: torch.Tensor, vad: torch.Tensor,
                     threshold: float = 0.0) -> torch.Tensor:
    """FN-SSL target: binarise the VAD, gate each source's IPD, sum over
    sources.

    Args:
      ipd_ri: (nb, nt, 2nf, P, ns) real/imag targets.
      vad: (nb, nt, ns) soft VAD.
    Returns:
      (nb, nt, 2nf, P).
    """
    gate = (vad > threshold).to(ipd_ri.dtype)
    return (ipd_ri * gate[:, :, None, None, :]).sum(dim=-1)
