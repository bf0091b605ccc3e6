"""Device choice for the port's entry points: the card unless the caller
asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA device, and raises where there is
    none: the port runs on the CPU only when the caller says so."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (the CLI's "
                           "--platform cpu) to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
