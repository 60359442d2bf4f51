"""spray_tpu_torch binned cull+visit tracer (plain versions of the CUDA
visit kernels, on the CPU) == spray_tpu's (Pallas visit kernels in
interpret mode) over one build carried by interop, and the port's brute
oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.io import scenes as js
from spray_tpu.kernels import binned as jbin
from spray_tpu_torch.interop import binned_arrays, scene_from_arrays
from spray_tpu_torch.kernels import binned as tbin
from spray_tpu_torch.kernels.common import pad_rays
from spray_tpu_torch.oracle.brute import BruteIntersector as TBrute

BP = tbin.BP


def port_scene(s):
    return scene_from_arrays(s.vertices, s.faces, s.albedo, s.emission)


def rand_rays(scene, n, rng, centered=False):
    """The rays of tests/test_binned.py."""
    v = np.asarray(scene.vertices)
    lo, hi = v.min(0), v.max(0)
    ctr, ext = (lo + hi) / 2, float((hi - lo).max())
    if centered:
        o = np.tile(ctr + np.array([0.0, 0.0, 2.0 * ext]), (n, 1))
        d = ctr + (rng.random((n, 3)) - 0.5) * ext - o
    else:
        o = ctr + rng.standard_normal((n, 3)) * ext
        d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o.astype(np.float32), d, ext


def windowed_rays(scene, n, centered, seed):
    rng = np.random.default_rng(seed)
    o, d, ext = rand_rays(scene, n, rng, centered)
    tmin = np.zeros(n, np.float32)
    tmax = np.where(rng.random(n) < 0.2, ext * 0.7, np.inf).astype(np.float32)
    tmax[:8] = 0.0  # dead rays must stay dead and not widen frustums
    return o, d, tmin, tmax


def assert_same_hits(hj, ht, occ_j, occ_t):
    """valid equal, t to atol 1e-4, prim differing only where t ties to
    1e-5 (the bar of tests/test_binned.py), occlusion equal."""
    vj, vt = np.asarray(hj.valid), np.asarray(ht.valid)
    np.testing.assert_array_equal(vt, vj)
    tj, tt = np.asarray(hj.t)[vj], np.asarray(ht.t)[vj]
    np.testing.assert_allclose(tt, tj, atol=1e-4)
    pj, pt = np.asarray(hj.prim)[vj], np.asarray(ht.prim)[vj]
    assert not ((pj != pt) & (np.abs(tj - tt) > 1e-5)).any()
    np.testing.assert_array_equal(np.asarray(occ_t), np.asarray(occ_j))


def check_against_oracle(scene, rays, ht, occ_t):
    o, d, tmin, tmax = map(torch.as_tensor, rays)
    hb = TBrute(port_scene(scene), device="cpu").intersect(o, d, tmin, tmax)
    occ_b = hb.valid & (hb.t > 0) & (hb.t < tmax)
    assert_same_hits(hb, ht, occ_b, occ_t)


# ------------------------------------------------------- (a) visit kernels

@pytest.fixture(scope="module")
def visit_case():
    """A hand-built visit list over 5 packets: runs of 3, 1 and 2 visits
    (a zero mask and a null supernode among them), packets 1 and 4 with no
    run, and a window that already holds a best t on some lanes."""
    scene = js.wisp_cloud(n_blobs=6, tris_per_blob=800, seed=2)
    b = jbin.BinnedScene(scene.vertices, scene.faces)
    s = b.num_supernodes
    assert s >= 4
    n = 5 * BP
    rng = np.random.default_rng(7)
    o, d, ext = rand_rays(scene, n, rng, centered=True)
    tmin = np.zeros(n, np.float32)
    tmin[5::9] = 2.0 * ext  # some windows start inside the scene
    tmax = np.full(n, np.inf, np.float32)
    tmax[::11] = 0.0  # dead lanes
    tmax[3::13] = 2.1 * ext
    visits = np.array([
        # pkt, sn, mask, first, last
        [0, 0, 0xFF, 1, 0],
        [0, 1, 0x00, 0, 0],
        [0, s, 0xFF, 0, 1],  # the null supernode
        [2, 2, 0xA5, 1, 1],
        [3, 1, 0x0F, 1, 0],
        [3, 0, 0xF1, 0, 1],
    ], np.int32)
    return scene, b, (o, d, tmin, tmax), visits


def test_visit_kernels_match_pallas(visit_case):
    _, b, (o, d, tmin, tmax), visits = visit_case
    cols = [np.ascontiguousarray(visits[:, i]) for i in range(5)]
    aug, _ = jbin._rays_to_aug(*map(jnp.asarray, (o, d, tmin, tmax)))
    p = aug.shape[0]
    code0 = np.full(p * BP, -1, np.int32)
    jt, jc = jbin._nearest_visits(
        *map(jnp.asarray, cols), aug, b.tri9,
        jnp.asarray(tmax).reshape(p, 1, BP),
        jnp.asarray(code0).reshape(p, 1, BP), True)
    arrs = binned_arrays(b)
    tri9 = torch.as_tensor(arrs["tri9"])
    tcols = [torch.as_tensor(c) for c in cols]
    to, td, tlo, thi = map(torch.as_tensor, (o, d, tmin, tmax))
    tt, tc = tbin.nearest_visits(*tcols, to, td, tlo, tri9, thi,
                                 torch.as_tensor(code0))
    visited = np.isin(np.arange(p), visits[:, 0]).repeat(BP)
    jt, jc = np.asarray(jt).reshape(-1), np.asarray(jc).reshape(-1)
    np.testing.assert_array_equal(tc.numpy()[visited], jc[visited])
    hit = jc[visited] >= 0
    assert hit.any() and (~hit).any()
    # the same formula in the same order; XLA's fusion may move one ulp
    np.testing.assert_allclose(tt.numpy()[visited], jt[visited], rtol=1e-6,
                               atol=1e-6)
    print("visit t bit-equal:", np.array_equal(tt.numpy()[visited], jt[visited]))
    # packets with no run keep their inputs (Pallas leaves them unwritten)
    np.testing.assert_array_equal(tt.numpy()[~visited], tmax[~visited])
    assert (tc.numpy()[~visited] == -1).all()
    # a second list carries the first one's best t as its window
    tt2, tc2 = tbin.nearest_visits(*tcols, to, td, tlo, tri9, tt, tc)
    assert torch.equal(tt2, tt) and torch.equal(tc2, tc)

    occ0 = np.zeros(p * BP, np.int32)
    occ0[BP * 3:BP * 3 + 40] = 1  # lanes occluded before this list
    jo = jbin._anyhit_visits(*map(jnp.asarray, cols), aug, b.tri9,
                             jnp.asarray(occ0).reshape(p, 1, BP), True)
    to_ = tbin.anyhit_visits(*tcols, to, td, tlo, thi, tri9,
                             torch.as_tensor(occ0))
    jo = np.asarray(jo).reshape(-1)
    np.testing.assert_array_equal(to_.numpy()[visited], jo[visited])
    np.testing.assert_array_equal(to_.numpy()[~visited], occ0[~visited])
    assert jo[visited].any()
    assert not jo[visited & (tmax == 0) & (occ0 == 0)].any()


def test_visit_wrappers_check_inputs(visit_case):
    _, b, (o, d, tmin, tmax), visits = visit_case
    tri9 = torch.as_tensor(binned_arrays(b)["tri9"])
    cols = [torch.as_tensor(np.ascontiguousarray(visits[:, i])) for i in range(5)]
    rays = [torch.as_tensor(x) for x in (o, d, tmin)]
    bt = torch.as_tensor(tmax)
    bc = torch.full_like(bt, -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tbin.nearest_visits(*cols, *rays, tri9, bt, bc.long())
    with pytest.raises(ValueError):
        tbin.nearest_visits(*cols[:4], cols[4][:-1], *rays, tri9, bt, bc)
    with pytest.raises(ValueError):
        tbin.anyhit_visits(*cols, rays[0][:-1], rays[1][:-1], rays[2][:-1],
                           bt[:-1], tri9, bc[:-1])
    before = dict(tbin.launches)
    tbin.nearest_visits(*cols, *rays, tri9, bt, bc)
    assert tbin.launches == before  # the plain version is no launch


# ------------------------------------------------------- (b) cull functions

@pytest.mark.parametrize("centered", [False, True], ids=["random", "coherent"])
def test_cull_functions_match_reference(centered):
    scene = js.wisp_cloud(n_blobs=6, tris_per_blob=800, seed=2)
    b = jbin.BinnedScene(scene.vertices, scene.faces)
    arrs = {k: torch.as_tensor(v) for k, v in binned_arrays(b).items()}
    o, d, tmin, tmax = windowed_rays(scene, 600, centered, seed=11)
    tmax[BP:2 * BP] = 0.0  # one whole packet dead
    aug, _ = jbin._rays_to_aug(*map(jnp.asarray, (o, d, tmin, tmax)))
    rays = pad_rays(*map(torch.as_tensor, (o, d, tmin, tmax)), BP)
    ji = jbin.packet_intervals(aug)
    ti = tbin.packet_intervals(*rays)
    for k in ji:
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)
    assert not ti["any_live"][1] and ti["any_live"][0]
    je = np.asarray(jbin.supernode_entries(ji, b.sbox))
    te = tbin.supernode_entries(ti, arrs["sbox"]).numpy()
    np.testing.assert_array_equal(np.isinf(te), np.isinf(je))
    fin = np.isfinite(je)
    assert fin.any() and (~fin).any() and np.isinf(te[1]).all()
    np.testing.assert_allclose(te[fin], je[fin], rtol=1e-6)
    # masks on the 3 nearest supernodes of each packet, by the reference's order
    sn = np.argsort(je, axis=1, kind="stable")[:, :3].astype(np.int32)
    sn[0, 2] = b.num_supernodes  # the null supernode: (+inf, -inf) boxes
    upper = np.array(jnp.max(aug[:, 5, 0:BP], axis=1))
    jm = np.asarray(jbin.cluster_masks(ji, b.cbox, jnp.asarray(sn),
                                       jnp.asarray(upper)))
    tm = tbin.cluster_masks(ti, arrs["cbox"], torch.as_tensor(sn),
                            torch.as_tensor(upper)).numpy()
    np.testing.assert_array_equal(tm, jm)
    assert jm.any() and (jm[1] == 0).all()  # the dead packet gates nothing
    # the coherence key, dead rays last
    jk = np.asarray(jbin.sort_key(*map(jnp.asarray, (o, d, tmin, tmax)),
                                  b.world_lo, b.world_hi))
    tk = tbin.sort_key(*map(torch.as_tensor, (o, d, tmin, tmax)),
                       arrs["world_lo"], arrs["world_hi"]).numpy()
    np.testing.assert_array_equal(tk, jk)
    assert (tk[tmax == 0] == 2**31 - 1).all()


def test_band_order_padding_and_phase_sizes():
    """`_sorted_order` pads by (-S) % k + k so every band slice is whole;
    the sort is stable on the +inf ties; the cascade sizes are the
    reference's."""
    entry = torch.tensor([[3.0, float("inf"), 1.0, float("inf"), 1.0],
                          [float("inf")] * 5])
    for k in (1, 2, 3, 5, 8):
        order, ent = tbin._sorted_order(entry, k)
        jo, je = jbin._sorted_order(jnp.asarray(entry.numpy()), k)
        np.testing.assert_array_equal(order.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(ent.numpy(), np.asarray(je))
        assert order.shape[1] % k == 0 and order.shape[1] >= 5 + k
    assert order[0, :5].tolist() == [2, 4, 0, 1, 3]
    for p, k, s in ((8192, 4, 2560), (5, 3, 2), (1, 4, 1), (64, 8, 3)):
        assert tbin._phase_sizes(p, k, s) == jbin._phase_sizes(p, k, s)


# ------------------------------------------------------- (c) the intersector

CASES = {
    "cornell_random": (lambda: js.cornell_box(), dict(k=3), False, 0),
    "cornell_coherent": (lambda: js.cornell_box(), dict(k=2), True, 1),
    "wisp_multi_supernode": (
        lambda: js.wisp_cloud(n_blobs=6, tris_per_blob=800, seed=2),
        dict(k=3), False, 2),
    "wisp_k1_many_rounds": (
        lambda: js.wisp_cloud(n_blobs=6, tris_per_blob=800, seed=2),
        dict(k=1), True, 3),
    "icosphere": (lambda: js.icosphere(3), dict(k=2), False, 4),
    "small_scene_few_supernodes": (lambda: js.icosphere(1), dict(k=8), False, 5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_binned_intersector_matches_reference_and_oracle(name):
    make, kw, centered, seed = CASES[name]
    scene = make()
    rays = windowed_rays(scene, 600, centered, seed)
    ji = jbin.BinnedIntersector(scene, interpret=True, **kw)
    ti = tbin.BinnedIntersector.from_arrays(port_scene(scene), binned_arrays(ji),
                                            device="cpu", **kw)
    assert ti.k == ji.k
    jr = [jnp.asarray(x) for x in rays]
    tr = [torch.as_tensor(x) for x in rays]
    hj, occ_j = ji.intersect(*jr), ji.occluded(jr[0], jr[1], jr[3])
    ht, occ_t = ti.intersect(*tr), ti.occluded(tr[0], tr[1], tr[3])
    assert_same_hits(hj, ht, occ_j, occ_t)
    check_against_oracle(scene, rays, ht, occ_t)
    assert ht.valid.any() and occ_t.any() and not ht.valid[:8].any()
    st = ti.stats
    assert st["calls"] == 2 and st["rounds"] >= 2 and st["syncs"] > st["rounds"]


def test_binned_unsorted_equals_sorted():
    scene = js.wisp_cloud(n_blobs=6, tris_per_blob=800, seed=2)
    rays = [torch.as_tensor(x) for x in windowed_rays(scene, 600, False, 6)]
    a = tbin.BinnedIntersector(port_scene(scene), k=2, device="cpu")
    b = tbin.BinnedIntersector(port_scene(scene), k=2, sort=False, device="cpu")
    ha, hb = a.intersect(*rays), b.intersect(*rays)
    assert torch.equal(ha.valid, hb.valid) and torch.equal(ha.t, hb.t)
    assert torch.equal(a.occluded(rays[0], rays[1], rays[3]),
                       b.occluded(rays[0], rays[1], rays[3]))
