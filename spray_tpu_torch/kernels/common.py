"""Shared host-side kernel helpers (numpy copies from
``spray_tpu/kernels/common.py``)."""

from __future__ import annotations

import numpy as np


def round_up(x, m):
    return -(-x // m) * m


def tile_swizzle_order(width, height, tile_w=32, tile_h=16):
    """Pixel ids in 2D-tile-major order: packets of consecutive rays become
    compact image tiles instead of thin row strips."""
    ids = np.arange(width * height, dtype=np.uint32).reshape(height, width)
    out = []
    for ty in range(0, height, tile_h):
        for tx in range(0, width, tile_w):
            out.append(ids[ty : ty + tile_h, tx : tx + tile_w].reshape(-1))
    return np.concatenate(out)
