"""Counter-based Threefry-2x32 RNG of the deployments' integrators, in
plain PyTorch: samples are addressed by (seed, pixel, sample, dimension).

Each uint32 word lives in an int64 tensor and is masked back to 32 bits
after each add and left shift.
"""

from __future__ import annotations

import torch

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_KEY1 = 0x3443F9A5
_MASK = 0xFFFFFFFF

PIXEL_JITTER = 0
BSDF = 2
LIGHT = 3

_N_PURPOSE = 8
_N_COMPONENT = 4


def dim_id(bounce, purpose, component=0):
    """Pack (bounce, purpose, component) into one counter dimension."""
    return (bounce * _N_PURPOSE + purpose) * _N_COMPONENT + component


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(key0, key1, x0, x1):
    """20 rounds of Threefry-2x32 on uint32 words held in int64 tensors."""
    k0 = int(key0) & _MASK
    k1 = int(key1) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for chunk in range(5):
        for r in (_ROT[0:4] if chunk % 2 == 0 else _ROT[4:8]):
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(chunk + 1) % 3]) & _MASK
        x1 = (x1 + ks[(chunk + 2) % 3] + chunk + 1) & _MASK
    return x0, x1


def uniform(seed, pixel, sample, dim):
    """float32 uniform in [0, 1) from the top 24 bits of the counter's
    first output word."""
    x0 = pixel.to(torch.int64) & _MASK
    x1 = ((sample.to(torch.int64) & _MASK) << 16 & _MASK) | (int(dim) & _MASK)
    x0, x1 = torch.broadcast_tensors(x0, x1)
    b0, _ = threefry2x32(seed, _KEY1, x0, x1)
    return (b0 >> 8).to(torch.float32) * (1.0 / (1 << 24))
