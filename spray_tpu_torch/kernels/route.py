"""The in-situ router's send layout in a hand-written CUDA kernel
(``csrc/route.cu``), with its plain PyTorch version.

Each round of the collective epoch loop (`dist/epochs.py`) sends up to
`bucket` rays to each owner rank: slot ``owner * bucket + k`` of the send
buffer holds the lane of the k-th ray, in lane order, whose destination is
that owner, and ``m`` (the spare state row) where no ray fills the slot.
The reference computes the rank with a `jnp.cumsum` of the one-hot owner
(``spray_tpu/dist/epochs.py``), which is no Pallas kernel; the plain
version here is that formulation.  On the card a cumsum over the rays of an
(m, ndev) tensor is a serial scan a column, so the CUDA kernel counts each
owner's rays a block and ranks each ray by prefix sums over blocks, warps
and lanes instead.

The wrapper sends a CPU tensor to the plain version and launches the CUDA
kernel for a CUDA tensor (or raises); there is no fallback between them.
"""

from __future__ import annotations

import torch

from . import _build

MAX_NDEV = 64  # owners the kernel's shared-memory tables hold (route.cu)
MAX_BLOCKS = 256  # rows of the kernel's count table (route.cu)
# launches of the CUDA kernel by its wrapper (the plain version never counts)
launches = {"route_slots_kernel": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def route_slots_reference(dest, ndev, bucket):
    """Plain PyTorch version of `route_slots_kernel`: the stable rank of a
    ray among those with its owner is a cumsum of the one-hot owner, and
    the selected lanes are scattered into their slots, the unsent ones into
    a spare slot that is cut off."""
    m, dev = dest.shape[0], dest.device
    slots = ndev * bucket
    ranks = torch.arange(ndev, device=dev)
    rank = torch.cumsum((dest[:, None] == ranks[None]).to(torch.int32),
                        dim=0) - 1
    rank_i = torch.gather(rank, 1, torch.clamp(dest, max=ndev - 1)[:, None])[:, 0]
    sel = (dest < ndev) & (rank_i < bucket)
    slot = torch.where(sel, dest * bucket + rank_i, slots)
    send = torch.full((slots + 1,), m, dtype=torch.int64, device=dev)
    send.scatter_(0, slot, torch.arange(m, device=dev))
    return send[:slots]


def route_slots(dest, ndev, bucket):
    """The send layout of one round.

    dest (m,) int64: each ray's owner rank in [0, ndev), or ndev for a ray
    with no destination; 1 <= ndev <= MAX_NDEV; bucket >= 1 rays per owner.
    Returns send (ndev * bucket,) int64: slot owner * bucket + k holds the
    lane of the k-th ray, in lane order, bound for that owner, or m where
    fewer rays go there; rays past an owner's bucket are not sent."""
    _build.check_tensors(dest.device, [("dest", dest, torch.int64, 1)])
    if not 1 <= ndev <= MAX_NDEV:
        raise ValueError(f"ndev: want 1 to {MAX_NDEV} owners, got {ndev}")
    if bucket < 1:
        raise ValueError(f"bucket: want at least 1 ray per owner, got {bucket}")
    if dest.device.type == "cpu":
        return route_slots_reference(dest, ndev, bucket)
    if dest.device.type != "cuda":
        raise ValueError(f"unsupported device {dest.device}")
    m = dest.shape[0]
    if m >= 2**31 or bucket >= 2**31:
        raise ValueError("route_slots: rays and bucket must fit in int32")
    if m == 0:
        return torch.zeros(ndev * bucket, dtype=torch.int64, device=dest.device)
    send = torch.empty(ndev * bucket, dtype=torch.int64, device=dest.device)
    table = torch.empty((MAX_BLOCKS, ndev), dtype=torch.int32,
                        device=dest.device)
    _build.launch("route", "spray_route_slots", dest.device, dest.data_ptr(),
                  m, ndev, bucket, table.data_ptr(), send.data_ptr())
    launches["route_slots_kernel"] += 1
    return send
