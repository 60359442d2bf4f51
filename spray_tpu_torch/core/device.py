"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None):
    """``None`` means the CUDA card.  Raises when CUDA is asked for and no
    card is present: the entry points never fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spray_tpu_torch needs a CUDA device (pass device='cpu' to run "
            "the plain PyTorch versions of the kernels)"
        )
    return dev
