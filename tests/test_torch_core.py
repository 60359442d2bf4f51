"""spray_tpu_torch core (RNG, geometry, camera, swizzle) == spray_tpu core."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.core import camera as j_camera
from spray_tpu.core import geom as j_geom
from spray_tpu.core import rng as j_rng
from spray_tpu.kernels.common import tile_swizzle_order as j_swizzle
from spray_tpu_torch.core import camera as t_camera
from spray_tpu_torch.core import geom as t_geom
from spray_tpu_torch.core import rng as t_rng
from spray_tpu_torch.kernels.common import tile_swizzle_order as t_swizzle


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


@pytest.mark.parametrize("wh", [(16, 16), (512, 512), (100, 37)])
def test_tile_swizzle_order_equal(wh):
    np.testing.assert_array_equal(t_swizzle(*wh), j_swizzle(*wh))
