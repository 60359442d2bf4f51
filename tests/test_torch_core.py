"""spray_tpu_torch core (RNG, geometry, camera, swizzle) == spray_tpu core."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.core import camera as j_camera
from spray_tpu.core import geom as j_geom
from spray_tpu.core import rng as j_rng
from spray_tpu.kernels.common import tile_swizzle_order as j_swizzle
from spray_tpu_torch.core import camera as t_camera
from spray_tpu_torch.core.config import RenderConfig
from spray_tpu_torch.core import geom as t_geom
from spray_tpu_torch.core import rng as t_rng
from spray_tpu_torch.integrators import wavefront
from spray_tpu_torch.io.scenes import cornell_box
from spray_tpu_torch.kernels.common import tile_swizzle_order as t_swizzle
from spray_tpu_torch.oracle.brute import BruteIntersector


def _grid():
    """(pixel, sample, dim) grid with pixel ids up to 2^32 - 1 (wrap edge)."""
    rs = np.random.RandomState(0)
    pix = np.concatenate([
        np.arange(4096, dtype=np.uint64),
        rs.randint(0, 2**32, size=4096, dtype=np.uint64),
        np.array([2**32 - 1, 2**31, 2**31 - 1], np.uint64),
    ])
    return pix


@pytest.mark.parametrize("seed", [0, 5, 0xFFFFFFFF])
def test_threefry_bits_and_uniform_bit_exact(seed):
    pix = _grid()
    pt = torch.as_tensor(pix.astype(np.int64))
    for sample in (0, 1, 3, 65535):
        for dim in (t_rng.dim_id(0, t_rng.PIXEL_JITTER, 0),
                    t_rng.dim_id(2, t_rng.LIGHT, 2),
                    t_rng.dim_id(7, t_rng.AO, 1)):
            ref = j_rng.random_bits(seed, pix.astype(np.uint32), sample, dim, np)
            got = t_rng.random_bits(seed, pt, sample, dim).numpy()
            np.testing.assert_array_equal(got.astype(np.uint32), ref)
            uref = np.asarray(j_rng.uniform(
                seed, jnp.asarray(pix.astype(np.uint32)), sample, dim, jnp))
            ugot = t_rng.uniform(seed, pt, sample, dim).numpy()
            np.testing.assert_array_equal(ugot.view(np.uint32),
                                          uref.view(np.uint32))
    # tensor-valued sample index (the spp-batched wavefront)
    smp = np.arange(pix.size) % 4
    ref = j_rng.random_bits(seed, pix.astype(np.uint32),
                            smp.astype(np.uint32), 9, np)
    got = t_rng.random_bits(seed, pt, torch.as_tensor(smp), 9).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), ref)


UNIFORMS_DIMS = [
    (t_rng.dim_id(0, t_rng.PIXEL_JITTER, 0),),
    (t_rng.dim_id(0, t_rng.PIXEL_JITTER, 0), t_rng.dim_id(0, t_rng.PIXEL_JITTER, 1)),
    tuple(t_rng.dim_id(2, t_rng.LIGHT, c) for c in range(3)),
    (t_rng.dim_id(7, t_rng.AO, 1), t_rng.dim_id(1, t_rng.BSDF, 0), 9,
     t_rng.dim_id(0, t_rng.PIXEL_JITTER, 0)),
]


@pytest.mark.parametrize("seed", [0, 5, 0xFFFFFFFF])
@pytest.mark.parametrize("sample", [0, 65535, "tensor"])
@pytest.mark.parametrize("dims", UNIFORMS_DIMS, ids=lambda d: f"k{len(d)}")
def test_uniforms_equal_uniform_and_reference(seed, sample, dims):
    """`uniforms` (the integrators' entry point) draws, dim by dim, the bits
    of `uniform` and of the reference's `uniform`."""
    pix = _grid()
    pt = torch.as_tensor(pix.astype(np.int64))
    if sample == "tensor":
        smp = np.arange(pix.size) % 16
        s_t, s_j = torch.as_tensor(smp), jnp.asarray(smp.astype(np.uint32))
    else:
        s_t, s_j = sample, sample
    got = t_rng.uniforms(seed, pt, s_t, dims)
    assert isinstance(got, tuple) and len(got) == len(dims)
    for row, dim in zip(got, dims):
        assert row.dtype == torch.float32 and row.shape == pt.shape
        one = t_rng.uniform(seed, pt, s_t, dim)
        np.testing.assert_array_equal(row.numpy().view(np.uint32),
                                      one.numpy().view(np.uint32))
        uref = np.asarray(j_rng.uniform(
            seed, jnp.asarray(pix.astype(np.uint32)), s_j, dim, jnp))
        np.testing.assert_array_equal(row.numpy().view(np.uint32),
                                      uref.view(np.uint32))


@pytest.mark.parametrize("bad", ["int32", "strided", "2d", "five_dims",
                                 "no_dims", "sample_int32", "sample_shape"])
def test_uniforms_rejects(bad):
    """`uniforms` raises on what the kernel does not take, before it looks
    at the device (so on the CPU too), and counts no launch."""
    pix = torch.arange(64, dtype=torch.int64)
    sample, dims = 0, (1, 2)
    if bad == "int32":
        pix = pix.to(torch.int32)
    elif bad == "strided":
        pix = torch.arange(128, dtype=torch.int64)[::2]
    elif bad == "2d":
        pix = pix.reshape(8, 8)
    elif bad == "five_dims":
        dims = (0, 1, 2, 3, 4)
    elif bad == "no_dims":
        dims = ()
    elif bad == "sample_int32":
        sample = torch.zeros(64, dtype=torch.int32)
    elif bad == "sample_shape":
        sample = torch.zeros(63, dtype=torch.int64)
    t_rng.reset_launches()
    with pytest.raises(ValueError):
        t_rng.uniforms(5, pix, sample, dims)
    assert t_rng.launches == {"threefry_uniform_kernel": 0}


def test_uniforms_empty_and_no_launch_on_cpu():
    """N = 0 gives empty rows; the CPU path never counts a kernel launch."""
    t_rng.reset_launches()
    rows = t_rng.uniforms(3, torch.zeros(0, dtype=torch.int64), 1, (4, 5, 6))
    assert [tuple(r.shape) for r in rows] == [(0,)] * 3
    assert all(r.dtype == torch.float32 for r in rows)
    t_rng.uniform2(3, torch.arange(8, dtype=torch.int64), 0, 1, t_rng.BSDF)
    assert t_rng.launches == {"threefry_uniform_kernel": 0}


def _unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_camera_rays_match():
    kw = dict(eye=(14.0, 10.0, 18.0), lookat=(0, 0, 0), up=(0, 1, 0),
              fov_y_deg=45, width=40, height=24)
    jc, tc = j_camera.make_camera(**kw), t_camera.make_camera(**kw)
    for f in ("eye", "lower_left", "du", "dv"):
        np.testing.assert_array_equal(getattr(jc, f), getattr(tc, f))
    rs = np.random.RandomState(1)
    pid = np.arange(40 * 24, dtype=np.uint32)
    jx, jy = (rs.uniform(size=pid.size).astype(np.float32) for _ in range(2))
    oj, dj = j_geom.camera_rays(jc, jnp.asarray(pid), jnp.asarray(jx),
                                jnp.asarray(jy), jnp)
    ot, dt = t_geom.camera_rays(tc, torch.as_tensor(pid.astype(np.int64)),
                                torch.as_tensor(jx), torch.as_tensor(jy))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)


def test_sampling_math_matches():
    rs = np.random.RandomState(2)
    u1, u2 = (rs.uniform(size=2000).astype(np.float32) for _ in range(2))
    n = _unit(rs, 2000)
    loc_j = j_geom.cosine_hemisphere(jnp.asarray(u1), jnp.asarray(u2), jnp)
    loc_t = t_geom.cosine_hemisphere(torch.as_tensor(u1), torch.as_tensor(u2))
    np.testing.assert_allclose(loc_t.numpy(), np.asarray(loc_j), atol=1e-6)
    w_j = j_geom.local_to_world(loc_j, jnp.asarray(n), jnp)
    w_t = t_geom.local_to_world(loc_t, torch.as_tensor(n))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)


def test_moller_trumbore_and_face_normals_match():
    rs = np.random.RandomState(3)
    n = 3000
    ro = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    rd = _unit(rs, n)
    v0 = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    e2 = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    outs_j = j_geom.moller_trumbore(*map(jnp.asarray, (ro, rd, v0, e1, e2)), jnp)
    outs_t = t_geom.moller_trumbore(*map(torch.as_tensor, (ro, rd, v0, e1, e2)))
    np.testing.assert_array_equal(outs_t[3].numpy(), np.asarray(outs_j[3]))
    ok = np.asarray(outs_j[3])
    assert ok.any()
    for a, b in zip(outs_t[:3], outs_j[:3]):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok],
                                   rtol=1e-6, atol=1e-6)
    verts = rs.uniform(-1, 1, (300, 3)).astype(np.float32)
    faces = rs.randint(0, 300, (500, 3)).astype(np.int32)
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                  & (faces[:, 0] != faces[:, 2])]
    nj = j_geom.face_normals(verts, faces, np)
    nt = t_geom.face_normals(torch.as_tensor(verts), torch.as_tensor(faces))
    np.testing.assert_allclose(nt.numpy(), nj, atol=1e-6)


@pytest.mark.parametrize("case", ["finite", "nonfinite", "zero"])
def test_gather_rows_backward_is_order_free(case):
    """gather_rows' backward gives the same bits whatever the order of the
    lanes, so the card's atomics cannot change them; it equals the exact
    sum within 1e-6 of the largest row and the reference's gather gradient
    within float32 summation; a non-finite gradient makes it all NaN."""
    rs = np.random.RandomState(5)
    n, rows = 200_000, 64
    idx = rs.randint(0, rows, n)
    idx[: n // 2] = rows - 1  # one long run, as every miss lane reads one row
    w = rs.standard_normal((n, 3)).astype(np.float32) * rs.uniform(
        0, 1e3, (n, 1)).astype(np.float32)
    if case == "nonfinite":
        w[[10, 11, 12], [0, 1, 1]] = [np.inf, np.nan, -np.inf]
    elif case == "zero":
        w[:] = 0.0

    def grad(perm):
        t = torch.zeros(rows, 3, requires_grad=True)
        out = t_geom.gather_rows(t, torch.as_tensor(idx[perm]))
        (out * torch.as_tensor(w[perm])).sum().backward()
        return t.grad.numpy()

    g = grad(np.arange(n))
    for seed in (1, 2):
        assert grad(np.random.RandomState(seed).permutation(n)).tobytes() == g.tobytes()
    if case == "nonfinite":
        assert np.isnan(g).all()
        return
    exact = np.zeros((rows, 3))
    np.add.at(exact, idx, w.astype(np.float64))
    jg = np.asarray(jax.grad(lambda t: jnp.sum(t[idx] * w))(jnp.zeros((rows, 3))))
    scale = max(np.abs(exact).max(), 1e-30)
    assert np.abs(g - exact).max() <= 1e-6 * scale
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-5 * scale)
    if case == "zero":
        assert not g.any()


@pytest.mark.parametrize("wh", [(16, 16), (512, 512), (100, 37)])
def test_tile_swizzle_order_equal(wh):
    np.testing.assert_array_equal(t_swizzle(*wh), j_swizzle(*wh))


@pytest.mark.parametrize("integrator,bounces,calls", [
    ("pt", 2, 5), ("pt", 3, 7), ("ao", 1, 1 + 3)])
def test_uniforms_one_call_a_draw_site(integrator, bounces, calls,
                                       monkeypatch):
    """A wave calls `uniforms` once a draw site: the jitter pair, then with
    NEE the light triple and the BSDF pair at every bounce but the last
    (1 + 2 x bounces, the kernel's launches on the card), or AO's pair a
    sample; the dims and their order are the reference's."""
    seen = []
    plain = t_rng.uniforms

    def counted(seed, pixel, sample, dims):
        seen.append(tuple(dims))
        return plain(seed, pixel, sample, dims)

    monkeypatch.setattr(t_rng, "uniforms", counted)
    scene = cornell_box()
    cam = t_camera.make_camera(eye=(0.5, 0.5, 2.2), lookat=(0.5, 0.5, 0.0),
                               up=(0, 1, 0), fov_y_deg=40, width=8, height=8)
    cfg = RenderConfig(width=8, height=8, spp=1, bounces=bounces,
                       integrator=integrator, ao_samples=3, seed=4)
    arrays = wavefront.make_scene_arrays(scene, "cpu")
    wavefront.sample_wavefront(arrays, cam, cfg,
                               BruteIntersector(scene, device="cpu"), 0,
                               torch.arange(64, dtype=torch.int64))
    assert len(seen) == calls
    d = t_rng.dim_id
    assert seen[0] == (d(0, t_rng.PIXEL_JITTER, 0), d(0, t_rng.PIXEL_JITTER, 1))
    if integrator == "pt":
        for b in range(bounces):
            assert seen[1 + 2 * b] == tuple(d(b, t_rng.LIGHT, c) for c in range(3))
            assert seen[2 + 2 * b] == (d(b, t_rng.BSDF, 0), d(b, t_rng.BSDF, 1))
    else:
        assert seen[1:] == [(d(k, t_rng.AO, 0), d(k, t_rng.AO, 1))
                            for k in range(3)]
