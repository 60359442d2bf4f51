"""Counter-based Threefry-2x32 RNG, bit-exact with ``spray_tpu.core.rng``.

torch has no uint32 add or shifts, so every uint32 word lives in an int64
tensor and is masked back to 32 bits after each add and left shift (right
shifts of a value below 2^32 are already logical).  Streams are addressed by
(pixel_id, sample_idx, dim) exactly as in the reference, so the port draws the
same samples as the JAX renderer and the numpy oracle.
"""

from __future__ import annotations

import torch

from .. import trace

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_KEY1 = 0x3443F9A5
_MASK = 0xFFFFFFFF

PIXEL_JITTER = 0
LENS = 1
BSDF = 2
LIGHT = 3
RUSSIAN_ROULETTE = 4
AO = 5

_N_PURPOSE = 8
_N_COMPONENT = 4


def dim_id(bounce, purpose, component=0):
    """Pack (bounce, purpose, component) into one counter dimension."""
    return (bounce * _N_PURPOSE + purpose) * _N_COMPONENT + component


def _u32(x, device=None):
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def _rotl(x, d):
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(key0, key1, x0, x1):
    """20-round Threefry-2x32 on uint32 words held in int64 tensors."""
    k0 = int(key0) & _MASK
    k1 = int(key1) & _MASK
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for chunk in range(5):
        # a span a chunk: a whole draw is ~500 host events on the card,
        # past what a profile looks back for the innermost running span
        with trace.span("spray.glue.rng"):
            rots = _ROT[0:4] if chunk % 2 == 0 else _ROT[4:8]
            for r in rots:
                x0 = (x0 + x1) & _MASK
                x1 = _rotl(x1, r) ^ x0
            x0 = (x0 + ks[(chunk + 1) % 3]) & _MASK
            x1 = (x1 + ks[(chunk + 2) % 3] + chunk + 1) & _MASK
    return x0, x1


def random_bits(seed, pixel, sample, dim):
    """uint32 bits (int64 tensor) for counter (pixel, sample, dim) under seed.

    pixel: int tensor of flat pixel ids; sample: int or int tensor; dim: int.
    """
    dev = pixel.device
    x0 = _u32(pixel, dev)
    x1 = ((_u32(sample, dev) << 16) & _MASK) | (int(dim) & _MASK)
    x0, x1 = torch.broadcast_tensors(x0, x1)
    b0, _ = threefry2x32(seed, _KEY1, x0, x1)
    return b0


def uniform(seed, pixel, sample, dim):
    """float32 uniform in [0, 1) from the top 24 bits (exact in fp32)."""
    with trace.span("spray.glue.rng"):
        bits = random_bits(seed, pixel, sample, dim)
        return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform2(seed, pixel, sample, bounce, purpose):
    """Two independent uniforms (components 0 and 1)."""
    u1 = uniform(seed, pixel, sample, dim_id(bounce, purpose, 0))
    u2 = uniform(seed, pixel, sample, dim_id(bounce, purpose, 1))
    return u1, u2
