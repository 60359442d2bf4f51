"""The Threefry kernel (``kernels/csrc/rng.cu``, through `core.rng.uniforms`)
against the plain int64 version, bit for bit, on the card; and the
integrators' main path through it.

Every case needs a CUDA card and skips without one.  This file imports no
JAX: run it on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_rng_kernel.py``.  What `uniforms` rejects it rejects before
it looks at the device: tests/test_torch_core.py holds that on the CPU."""

import numpy as np
import pytest
import torch

from spray_tpu_torch.core import rng
from spray_tpu_torch.core.camera import make_camera
from spray_tpu_torch.core.config import RenderConfig
from spray_tpu_torch.integrators.device import make_render_fn
from spray_tpu_torch.integrators.wavefront import make_scene_arrays
from spray_tpu_torch.io.scenes import wisp_cloud
from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector

pytestmark = pytest.mark.cuda

SEEDS = [0, 5, 0xFFFFFFFF]
SAMPLES = [0, 1, 3, 65535, "tensor"]
SIZES = [0, 1, 1023, 1025, 4194304]
D = [rng.dim_id(0, rng.PIXEL_JITTER, 0), rng.dim_id(2, rng.LIGHT, 2),
     rng.dim_id(3, rng.BSDF, 1), rng.dim_id(7, rng.AO, 1)]
# K = 1 to 4 dims a call, in orders other than the kernel's rows
DIM_SETS = [(D[3],), (D[0], D[2]), (D[1], D[3], D[0]), (D[0], D[1], D[2], D[3])]
EDGES = [0, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 7, 2**40 + 3,
         2**63 - 1, -1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


def _pixels(n):
    """n int64 pixel ids: the 32-bit edges and ids above 2^32 first, then
    random ids below 2^34."""
    rs = np.random.RandomState(n)
    ids = np.concatenate([np.array(EDGES, np.int64),
                          rs.randint(0, 2**34, size=n, dtype=np.int64)])
    return torch.as_tensor(ids[:n])


def _sample(sample, n):
    return torch.arange(n, dtype=torch.int64) % 16 if sample == "tensor" else sample


def _bits(rows):
    return [r.cpu().view(torch.int32) for r in rows]


def _draw(seed, pix, sample, dims, card):
    """The kernel's rows for the CPU inputs, and the launches it counted."""
    s = sample.to(card) if isinstance(sample, torch.Tensor) else sample
    before = rng.launches["threefry_uniform_kernel"]
    rows = rng.uniforms(seed, pix.to(card), s, dims)
    torch.cuda.synchronize()
    assert len(rows) == len(dims)
    assert all(r.device.type == "cuda" and r.dtype == torch.float32
               and r.shape == pix.shape for r in rows)
    return rows, rng.launches["threefry_uniform_kernel"] - before


@pytest.mark.parametrize("n", SIZES[:-1])
@pytest.mark.parametrize("sample", SAMPLES)
@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_bits_equal_cpu_uniform(card, seed, sample, n):
    """Every row of every K, bit for bit, against `uniform` on the CPU."""
    pix, smp = _pixels(n), _sample(sample, n)
    want = {d: rng.uniform(seed, pix, smp, d).view(torch.int32) for d in D}
    for dims in DIM_SETS:
        rows, launched = _draw(seed, pix, smp, dims, card)
        assert launched == (1 if n else 0)
        for got, d in zip(_bits(rows), dims):
            assert torch.equal(got, want[d]), (seed, sample, n, dims, d)


@pytest.mark.parametrize("sample", SAMPLES)
@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_bits_full_wave(card, seed, sample):
    """At a spp-16 wave's 4,194,304 rays, against the plain int64 version
    run on the card's tensors (the same torch ops as on the CPU)."""
    n = SIZES[-1]
    pix, smp = _pixels(n), _sample(sample, n)
    on_card = smp.to(card) if isinstance(smp, torch.Tensor) else smp
    for dims in DIM_SETS:
        rows, launched = _draw(seed, pix, smp, dims, card)
        assert launched == 1
        for got, d in zip(rows, dims):
            want = rng._uniform_plain(seed, pix.to(card), on_card, d)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_kernel_bits_full_wave_cpu(card):
    """One full wave, K = 4, against `uniform` on the CPU itself."""
    n, seed = SIZES[-1], 0xFFFFFFFF
    pix, smp = _pixels(n), _sample("tensor", n)
    rows, _ = _draw(seed, pix, smp, DIM_SETS[-1], card)
    for got, d in zip(_bits(rows), DIM_SETS[-1]):
        assert torch.equal(got, rng.uniform(seed, pix, smp, d).view(torch.int32))


def _plain_uniforms(seed, pixel, sample, dims):
    return tuple(rng._uniform_plain(seed, pixel, sample, d) for d in dims)


@pytest.mark.parametrize("bounces", [2, 3])
def test_main_path_goes_through_kernel(card, bounces, monkeypatch):
    """A spp-batched PT+NEE frame on the card draws 1 + 2 x bounces kernel
    launches (the jitter pair, then the light triple and the BSDF pair at
    every bounce but the last), and its image is byte-equal to the same
    frame drawn by the plain int64 version on the card's tensors."""
    scene = wisp_cloud(n_blobs=8, tris_per_blob=80, extent=4.0, seed=5,
                       emissive_frac=0.5)
    assert np.asarray(scene.emission).max() > 0  # lights, so NEE draws
    cam = make_camera(eye=(7.0, 5.0, 9.0), lookat=(0.0, 0.0, 0.0),
                      up=(0, 1, 0), fov_y_deg=45, width=32, height=32)
    cfg = RenderConfig(width=32, height=32, spp=4, bounces=bounces, seed=11)
    isect = MultiDomainClusterIntersector(scene, device=card)
    fn = make_render_fn(scene, cam, cfg, isect, device=card)
    assert fn.spp_batch
    arrays = make_scene_arrays(scene, card)
    rng.reset_launches()
    img = fn(arrays)
    torch.cuda.synchronize()
    assert rng.launches["threefry_uniform_kernel"] == 1 + 2 * bounces
    monkeypatch.setattr(rng, "uniforms", _plain_uniforms)
    ref = fn(arrays)
    assert rng.launches["threefry_uniform_kernel"] == 1 + 2 * bounces
    assert img.cpu().numpy().tobytes() == ref.cpu().numpy().tobytes()
