"""Device selection for the port's entry points."""

from __future__ import annotations

import os

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


def free_bytes(device):
    """Bytes that new tensors on `device` can surely take now: on a card,
    the free memory CUDA reports (`torch.cuda.mem_get_info`; what torch's
    caching allocator holds unused is not counted: it may be split among
    blocks still partly in use); on the host, its free physical memory."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
