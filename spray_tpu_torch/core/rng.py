"""Counter-based Threefry-2x32 RNG, bit-exact with ``spray_tpu.core.rng``.

Streams are addressed by (pixel_id, sample_idx, dim) exactly as in the
reference, so the port draws the same samples as the JAX renderer and the
numpy oracle.  `uniforms` draws several dims of one counter at once: on the
card one launch of the hand-written CUDA kernel (``kernels/csrc/rng.cu``),
on the CPU the plain version below, dim by dim, with the same bits.  There
is no fallback between them.

The plain version: torch has no uint32 add or shifts, so every uint32 word
lives in an int64 tensor and is masked back to 32 bits after each add and
left shift (right shifts of a value below 2^32 are already logical).
"""

from __future__ import annotations

import torch

from .. import trace
from ..kernels import _build

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

MAX_DIMS = 4  # dims one kernel launch draws (csrc/rng.cu)
# launches of the CUDA kernel by its wrapper (the plain version never counts)
launches = {"threefry_uniform_kernel": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


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


def _uniform_plain(seed, pixel, sample, dim):
    bits = random_bits(seed, pixel, sample, dim)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniforms(seed, pixel, sample, dims):
    """float32 uniforms in [0, 1) from the top 24 bits (exact in fp32) of
    counters (pixel, sample, dim) under seed, for each of 1 to MAX_DIMS dims.

    pixel: contiguous (N,) int64 flat pixel ids; sample: an int, or a
    contiguous (N,) int64 tensor beside pixel (the spp-batched wavefront).
    Returns a tuple of one (N,) float32 tensor a dim, in the order of dims.
    A CUDA tensor launches `threefry_uniform_kernel` once (rows of one (K, N)
    buffer); a CPU tensor runs the plain version dim by dim."""
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= MAX_DIMS:
        raise ValueError(f"dims: want 1 to {MAX_DIMS}, got {len(dims)}")
    dev = pixel.device
    _build.check_tensors(dev, [("pixel", pixel, torch.int64, 1)])
    tensor = isinstance(sample, torch.Tensor)
    if tensor:
        _build.check_tensors(dev, [("sample", sample, torch.int64, 1)])
        if sample.shape != pixel.shape:
            raise ValueError(f"sample: want shape {tuple(pixel.shape)}, got "
                             f"{tuple(sample.shape)}")
    with trace.span("spray.glue.rng"):
        if dev.type == "cpu":
            return tuple(_uniform_plain(seed, pixel, sample, d) for d in dims)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        n = pixel.shape[0]
        out = torch.empty((len(dims), n), dtype=torch.float32, device=dev)
        if n == 0:
            return tuple(out)
        d = [x & _MASK for x in dims] + [0] * (MAX_DIMS - len(dims))
        _build.launch("rng", "spray_threefry_uniform", dev, pixel.data_ptr(),
                      sample.data_ptr() if tensor else None,
                      0 if tensor else int(sample) & _MASK,
                      int(seed) & _MASK, *d, len(dims), n, out.data_ptr())
        launches["threefry_uniform_kernel"] += 1
        return tuple(out)


def uniform(seed, pixel, sample, dim):
    """float32 uniform in [0, 1) from the top 24 bits (exact in fp32)."""
    return uniforms(seed, pixel, sample, (dim,))[0]


def uniform2(seed, pixel, sample, bounce, purpose):
    """Two independent uniforms (components 0 and 1)."""
    return uniforms(seed, pixel, sample, (dim_id(bounce, purpose, 0),
                                          dim_id(bounce, purpose, 1)))
