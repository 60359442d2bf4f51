"""Shared kernel helpers (copies from ``spray_tpu/kernels/common.py``) and
the packet padding of a wavefront."""

from __future__ import annotations

import numpy as np
import torch


def round_up(x, m):
    return -(-x // m) * m


def pad_rays(o, d, tmin, tmax, packet):
    """Pad a wavefront to whole packets with empty-window rays (d = 1,
    tmin = 1, tmax = 0: they never hit, as in the reference)."""
    n = o.shape[0]
    npad = round_up(max(n, packet), packet) - n
    if npad == 0:
        return o.contiguous(), d.contiguous(), tmin.contiguous(), tmax.contiguous()
    return (
        torch.cat([o, o.new_zeros(npad, 3)]),
        torch.cat([d, d.new_ones(npad, 3)]),
        torch.cat([tmin, tmin.new_ones(npad)]),
        torch.cat([tmax, tmax.new_zeros(npad)]),
    )


def tile_swizzle_order(width, height, tile_w=32, tile_h=16):
    """Pixel ids in 2D-tile-major order: packets of consecutive rays become
    compact image tiles instead of thin row strips."""
    ids = np.arange(width * height, dtype=np.uint32).reshape(height, width)
    out = []
    for ty in range(0, height, tile_h):
        for tx in range(0, width, tile_w):
            out.append(ids[ty : ty + tile_h, tx : tx + tile_w].reshape(-1))
    return np.concatenate(out)
