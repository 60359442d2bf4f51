"""spray_tpu_torch brute kernels (plain versions, on the CPU) ==
spray_tpu's Pallas brute kernels (interpret mode) on the same table and
rays, and the port's torch brute oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.io import scenes as js
from spray_tpu.kernels import brute as jb
from spray_tpu_torch.interop import brute_arrays, scene_from_arrays
from spray_tpu_torch.kernels import brute as tb
from spray_tpu_torch.oracle.brute import BruteIntersector as TBrute

N = 300  # not a tile multiple, as tests/test_kernels_brute.py


@pytest.fixture(scope="module")
def case():
    scene = js.cornell_box()
    rs = np.random.RandomState(0)
    o = rs.uniform(-0.2, 1.2, (N, 3)).astype(np.float32)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(N, np.float32)
    tmin[2::7] = 0.3
    tmax = np.full(N, np.inf, np.float32)
    tmax[::5] = 0.0  # dead lanes
    tmax[1::5] = 0.8  # a finite window
    jp = jb.PallasBruteIntersector(scene, interpret=True)
    tp = tb.PallasBruteIntersector.from_arrays(*brute_arrays(jp), device="cpu")
    rays = (o, d, tmin, tmax)
    ref_n = [np.asarray(x) for x in jb._brute_nearest(
        jp.tri9, jp.ids, *map(jnp.asarray, rays), interpret=True)]
    ref_o = np.asarray(jb._brute_anyhit(
        jp.tri9, jp.ids, *map(jnp.asarray, rays), interpret=True))
    return scene, jp, tp, rays, ref_n, ref_o


def test_table_equals_reference(case):
    scene, jp, tp, *_ = case
    tri9, ids = tb.brute_table(scene)
    assert tri9.tobytes() == np.asarray(jp.tri9).tobytes()
    np.testing.assert_array_equal(ids, np.asarray(jp.ids))
    assert torch.equal(tp.tri9, torch.as_tensor(tri9))


def test_brute_nearest_matches_pallas(case):
    _, _, tp, rays, (rt, rp, ru, rv), _ = case
    t, prim, u, v = (x.numpy() for x in tb.brute_nearest(
        tp.tri9, tp.ids, *map(torch.as_tensor, rays)))
    valid = rp >= 0
    np.testing.assert_array_equal(prim >= 0, valid)
    assert valid.any() and (~valid).any()
    # the same formula in the same order: 1e-5 / 1e-6 allows XLA's fusion
    np.testing.assert_allclose(t[valid], rt[valid], rtol=1e-5, atol=1e-6)
    assert (prim[valid] == rp[valid]).mean() >= 0.999
    np.testing.assert_allclose(u, ru, atol=2e-3)
    np.testing.assert_allclose(v, rv, atol=2e-3)
    # a miss (dead lanes included) returns its own tmax, prim -1, u = v = 0
    np.testing.assert_array_equal(t[~valid], rays[3][~valid])
    assert (u[~valid] == 0).all() and (v[~valid] == 0).all()
    dead = rays[3] == 0
    assert (prim[dead] == -1).all()


def test_brute_anyhit_matches_pallas(case):
    _, _, tp, rays, _, ref_o = case
    occ = tb.brute_anyhit(tp.tri9, tp.ids, *map(torch.as_tensor, rays)).numpy()
    np.testing.assert_array_equal(occ != 0, ref_o)
    assert ref_o.any() and not ref_o[rays[3] == 0].any()


def test_lowest_row_wins_exact_tie_and_negative_ids_never_hit():
    """Two copies of one triangle: the nearest hit reports the lower row; a
    row with id < 0 is skipped by both kernels' plain versions."""
    tri = np.array([[0, 0, 1, 1, 0, 0, 0, 1, 0]], np.float32)
    tri9 = torch.as_tensor(np.repeat(tri, 3, axis=0))
    o = torch.tensor([[0.2, 0.2, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    lo, hi = torch.zeros(1), torch.full((1,), 10.0)
    ids = torch.tensor([7, 5, 6], dtype=torch.int32)
    t, prim, _, _ = tb.brute_nearest(tri9, ids, o, d, lo, hi)
    assert prim.item() == 7 and t.item() == 1.0
    ids = torch.tensor([-1, 5, 6], dtype=torch.int32)
    assert tb.brute_nearest(tri9, ids, o, d, lo, hi)[1].item() == 5
    ids = torch.full((3,), -1, dtype=torch.int32)
    assert tb.brute_nearest(tri9, ids, o, d, lo, hi)[1].item() == -1
    assert tb.brute_anyhit(tri9, ids, o, d, lo, hi).item() == 0
    # the any-hit gate is strict: tmax == t is no hit, tmin == t neither
    ids = torch.arange(3, dtype=torch.int32)
    assert tb.brute_anyhit(tri9, ids, o, d, lo, torch.ones(1)).item() == 0
    assert tb.brute_anyhit(tri9, ids, o, d, torch.ones(1), hi).item() == 0
    assert tb.brute_nearest(tri9, ids, o, d, torch.ones(1), hi)[1].item() == 0


def test_intersector_matches_reference_and_torch_oracle(case):
    scene, jp, tp, rays, _, _ = case
    o, d, tmin, tmax = rays
    hj = jp.intersect(*map(jnp.asarray, rays))
    ht = tp.intersect(*map(torch.as_tensor, rays))
    pscene = scene_from_arrays(scene.vertices, scene.faces, scene.albedo,
                               scene.emission)
    hb = TBrute(pscene, device="cpu").intersect(*map(torch.as_tensor, rays))
    for ref in (hj, hb):
        valid = np.asarray(ref.valid)
        np.testing.assert_array_equal(ht.valid.numpy(), valid)
        np.testing.assert_allclose(ht.t.numpy()[valid], np.asarray(ref.t)[valid],
                                   rtol=1e-5, atol=1e-6)
        assert (ht.prim.numpy()[valid] == np.asarray(ref.prim)[valid]).mean() >= 0.999
    far = np.full(N, 1e30, np.float32)
    occ_j = np.asarray(jp.occluded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(far)))
    occ_t = tp.occluded(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(far))
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)


def test_wrappers_refuse_bad_inputs_and_count_no_plain_run(case):
    _, _, tp, rays, _, _ = case
    o, d, tmin, tmax = map(torch.as_tensor, rays)
    with pytest.raises(ValueError):
        tb.brute_nearest(tp.tri9, tp.ids.long(), o, d, tmin, tmax)
    with pytest.raises(ValueError):
        tb.brute_anyhit(tp.tri9[:, :8].contiguous(), tp.ids, o, d, tmin, tmax)
    with pytest.raises(ValueError):
        tb.brute_nearest(tp.tri9, tp.ids, o.T, d, tmin, tmax)
    # the plain versions never count as launches
    before = dict(tb.launches)
    tb.brute_nearest(tp.tri9, tp.ids, o, d, tmin, tmax)
    assert tb.launches == before
