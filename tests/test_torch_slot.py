"""The port's single-domain slot kernel (`nearest_slot`, plain version on
the CPU) and `ClusterBVHIntersector` == spray_tpu's `_nearest_call` and
`ClusterBVHIntersector` (Pallas in interpret mode) on identical pages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.io import scenes as js
from spray_tpu.kernels import traverse as jt
from spray_tpu.oracle.brute import BruteIntersector as JBrute
from spray_tpu_torch.interop import scene_from_arrays
from spray_tpu_torch.kernels import _build, traverse
from spray_tpu_torch.kernels.common import pad_rays

SCENES = {
    "cornell": (lambda: js.cornell_box(), 1),
    "sphere": (lambda: js.bumpy_sphere(subdiv=3), 2),
    "wisps": (lambda: js.wisp_cloud(n_blobs=8, tris_per_blob=80, extent=4.0), 3),
}
PACKET = 256


def _rand_rays(scene, n, seed):
    v = np.asarray(scene.vertices)
    lo, hi = v.min(0), v.max(0)
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _port(scene, cbvh):
    s = scene_from_arrays(scene.vertices, scene.faces, scene.albedo,
                          scene.emission)
    return traverse.ClusterBVHIntersector(s, cbvh=cbvh, device="cpu")


def _assert_hits_close(ref, got):
    """The bar of tests/test_kernels_traverse.py."""
    valid_r, valid_g = (np.asarray(h.valid) for h in (ref, got))
    np.testing.assert_array_equal(valid_r, valid_g)
    tr, tg = np.asarray(ref.t)[valid_r], np.asarray(got.t)[valid_r]
    np.testing.assert_allclose(tg, tr, rtol=2e-4, atol=2e-5)
    mismatch = np.asarray(ref.prim)[valid_r] != np.asarray(got.prim)[valid_r]
    real = mismatch & (np.abs(tr - tg) > 1e-4 * np.maximum(tr, 1))
    assert real.mean() < 0.002, f"non-tie prim mismatch {real.mean():.4f}"


@pytest.mark.parametrize("name", sorted(SCENES))
def test_cluster_intersector_matches_pallas_and_brute(name):
    make, seed = SCENES[name]
    scene = make()
    n = 1500  # several packets, not a multiple of the packet width
    o, d = _rand_rays(scene, n, seed)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[::7] = 0.0  # dead lanes
    far = np.full(n, 1e30, np.float32)
    jx = jt.ClusterBVHIntersector(scene, interpret=True)
    px = _port(scene, jx.host)
    args_j = [jnp.asarray(a) for a in (o, d, tmin, tmax)]
    args_t = [torch.as_tensor(a) for a in (o, d, tmin, tmax)]
    ht = px.intersect(*args_t)
    _assert_hits_close(jx.intersect(*args_j), ht)
    _assert_hits_close(JBrute(scene, jnp).intersect(*args_j), ht)
    occ_j = np.asarray(jx.occluded(args_j[0], args_j[1], jnp.asarray(far)))
    occ_t = px.occluded(args_t[0], args_t[1], torch.as_tensor(far)).numpy()
    np.testing.assert_array_equal(occ_t, occ_j)


def _slot_inputs(scene, cbvh, n, seed):
    """Identical packed inputs of both slot kernels, with whole dead
    packets: packet 1 has only empty windows, packet 3 a bucket of -1."""
    o, d = _rand_rays(scene, n, seed)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[PACKET : 2 * PACKET] = 0.0
    aug, _ = jt._rays_to_aug(*(jnp.asarray(a) for a in (o, d, tmin, tmax)),
                             PACKET)
    bucket = np.array(jt.live_buckets_from_aug(aug))
    bucket[3] = -1
    rays = pad_rays(*(torch.as_tensor(a) for a in (o, d, tmin, tmax)), PACKET)
    pages = [torch.as_tensor(np.ascontiguousarray(x))[None]
             for x in (cbvh.bounds, cbvh.meta, cbvh.w)]
    return aug, bucket, rays, pages


def test_slot_kernel_dead_packets_and_codes_match_nearest_call():
    scene = SCENES["wisps"][0]()
    cbvh = jt.build_cluster_bvh(np.asarray(scene.vertices),
                                np.asarray(scene.faces))
    n = 5 * PACKET - 100
    aug, bucket, rays, pages = _slot_inputs(scene, cbvh, n, 5)
    tj, cj = jt._nearest_call(jnp.asarray(bucket), *(jnp.asarray(p.numpy())
                                                      for p in pages),
                              aug, interpret=True)
    tj, cj = np.asarray(tj).reshape(-1), np.asarray(cj).reshape(-1)
    bt = torch.as_tensor(bucket)
    tt, ct = traverse.nearest_slot(bt, *rays, *pages, PACKET,
                                   traverse.tree_depth(cbvh.meta[None]))
    tt, ct = tt.numpy(), ct.numpy()
    # the live-bucket map is the reference's
    np.testing.assert_array_equal(
        traverse.live_buckets(rays[3].view(-1, PACKET)).numpy(),
        np.asarray(jt.live_buckets_from_aug(aug)))
    dead = np.repeat(bucket < 0, PACKET)
    assert dead.sum() == 2 * PACKET
    np.testing.assert_array_equal(tt[dead], 0.0)
    np.testing.assert_array_equal(tt[dead], tj[dead])
    np.testing.assert_array_equal(ct[dead], -1)
    np.testing.assert_array_equal(ct[dead], cj[dead])
    # live packets: same hit masks, domain-local codes, t to the key quantum
    np.testing.assert_array_equal(ct >= 0, cj >= 0)
    hit = ~dead & (ct >= 0)
    assert hit.sum() > 50
    np.testing.assert_allclose(tt[hit], tj[hit], rtol=2e-4)
    real = (ct[hit] != cj[hit]) & (np.abs(tt[hit] - tj[hit]) > 1e-4 * tt[hit])
    assert real.mean() < 0.002
    assert ct.max() < cbvh.w.shape[0] * (cbvh.w.shape[2] // 3)
    # a live lane with no hit keeps its tmax
    miss = ~dead & (ct < 0)
    np.testing.assert_array_equal(tt[miss], rays[3].numpy()[miss])


def test_slot_reference_is_one_round_of_nearest_reference():
    """On several pages the slot version picks the bucket's page and
    returns codes local to it."""
    from spray_tpu_torch.kernels.multidomain import build_cluster_domains

    scene = SCENES["wisps"][0]()
    pages = build_cluster_domains(
        scene_from_arrays(scene.vertices, scene.faces, scene.albedo,
                          scene.emission), 3)
    pg = [torch.as_tensor(pages[k]) for k in ("bounds", "meta", "w")]
    n = 4 * PACKET
    o, d = _rand_rays(scene, n, 8)
    rays = pad_rays(torch.as_tensor(o), torch.as_tensor(d), torch.zeros(n),
                    torch.full((n,), float("inf")), PACKET)
    bucket = torch.tensor([2, 0, -1, 1], dtype=torch.int32)
    depth = traverse.tree_depth(pages["meta"])
    t, code = traverse.nearest_slot(bucket, *rays, *pg, PACKET, depth)
    tg, cg = traverse.nearest(bucket[:, None].contiguous(), *rays, *pg,
                              PACKET, depth)
    per_dom = pg[2].shape[1] * (pg[2].shape[3] // 3)
    dom = bucket.repeat_interleave(PACKET)
    live = dom >= 0
    np.testing.assert_array_equal(t[live].numpy(), tg[live].numpy())
    np.testing.assert_array_equal(
        code[live].numpy(),
        torch.where(cg >= 0, cg - dom * per_dom, cg)[live].numpy())
    assert (code[live] >= 0).any() and (code < per_dom).all()
    assert (t[~live] == 0).all() and (code[~live] == -1).all()


def test_slot_wrapper_checks_and_signature():
    import ctypes

    sig = _build._SIGNATURES["spray_nearest_slot"]
    assert [i for i, a in enumerate(sig) if a is ctypes.c_void_p] == [
        0, 3, 4, 5, 6, 8, 9, 10, 14, 15, 16, 17]
    assert "int spray_nearest_slot(" in (_build.CSRC / "traverse.cu").read_text()
    rays = [torch.zeros(256, 3), torch.ones(256, 3), torch.zeros(256),
            torch.ones(256)]
    pages = [torch.zeros(1, 1, 8, 6), torch.full((1, 1, 8), -1, dtype=torch.int32),
             torch.zeros(1, 1, 4, 384)]
    bucket = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        traverse.nearest_slot(bucket.long(), *rays, *pages, 256, 1)
    with pytest.raises(ValueError):
        traverse.nearest_slot(torch.zeros(2, dtype=torch.int32), *rays, *pages,
                              256, 1)
    before = dict(traverse.launches)
    t, code = traverse.nearest_slot(bucket, *rays, *pages, 256, 1)
    assert traverse.launches == before  # the plain version never counts
    assert (code == -1).all() and (t == 1).all()


def _slot_walk(bucket, rays, pages, packet):
    """`walk_reference` over one-entry lists bucket[:, None], mapped to the
    slot contract: codes less the domain offset, a dead packet's lanes t 0
    and code -1.  This is what the warp-per-ray `nearest_slot_kernel`
    computes, counts included."""
    t, code, cnt = traverse.walk_reference(bucket[:, None], *rays, *pages, packet)
    dom = bucket.repeat_interleave(packet)
    per_dom = pages[2].shape[1] * (pages[2].shape[3] // 3)
    code = torch.where(code >= 0, code - dom * per_dom, -1)
    dead = dom < 0
    return (torch.where(dead, torch.zeros_like(t), t),
            torch.where(dead, -1, code).to(torch.int32), cnt)


@pytest.mark.parametrize("packet", [128, 256])
def test_slot_walk_matches_slot_reference_and_pallas(packet):
    """On three pages, with a packet of empty windows (bucket -1), a packet
    of live windows but bucket -1 and dead lanes in live packets: the walk
    in the slot contract == `nearest_slot_reference` (t bit for bit, codes
    off key-quantum ties) and == spray_tpu's Pallas `_nearest_kernel`
    (interpret mode) to the traversal tests' bar."""
    from spray_tpu.kernels import multidomain as jmd

    scene = SCENES["wisps"][0]()
    pages = jmd.build_cluster_domains(scene, 3)
    pg = [torch.as_tensor(np.ascontiguousarray(pages[k]))
          for k in ("bounds", "meta", "w")]
    n = 5 * packet - 40
    o, d = _rand_rays(scene, n, 9)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[::7] = 0.0  # dead lanes
    tmax[packet:2 * packet] = 0.0  # a packet with no live window
    rays = pad_rays(*(torch.as_tensor(a) for a in (o, d, tmin, tmax)), packet)
    bucket = torch.tensor([2, -1, 0, -1, 1], dtype=torch.int32)
    depth = traverse.tree_depth(pages["meta"])
    t_w, c_w, cnt = _slot_walk(bucket, rays, pg, packet)
    t_s, c_s = traverse.nearest_slot(bucket, *rays, *pg, packet, depth)
    np.testing.assert_array_equal(t_w.numpy().view(np.int32),
                                  t_s.numpy().view(np.int32))
    np.testing.assert_array_equal((c_w >= 0).numpy(), (c_s >= 0).numpy())
    assert (c_w != c_s).float().mean() < 0.01
    assert cnt["leaves"] > 0 and cnt["tests"] == cnt["leaves"] * (pg[2].shape[3] // 3)
    dom = bucket.repeat_interleave(packet)
    assert (t_w[dom < 0] == 0).all() and (c_w[dom < 0] == -1).all()
    dead_lane = (dom >= 0) & (rays[3] <= 0)
    assert dead_lane.any() and (c_w[dead_lane] == -1).all()
    np.testing.assert_array_equal(t_w[dead_lane].numpy(), rays[3][dead_lane].numpy())
    aug, _ = jt._rays_to_aug(*(jnp.asarray(a) for a in (o, d, tmin, tmax)), packet)
    tj, cj = jt._nearest_call(jnp.asarray(bucket.numpy()),
                              *(jnp.asarray(pages[k]) for k in ("bounds", "meta", "w")),
                              aug, interpret=True)
    tj, cj = np.asarray(tj).reshape(-1), np.asarray(cj).reshape(-1)
    tw, cw = t_w.numpy(), c_w.numpy()
    np.testing.assert_array_equal(cw >= 0, cj >= 0)
    np.testing.assert_array_equal(tw[cw < 0], tj[cw < 0])
    hit = cw >= 0
    assert hit.sum() > 20
    np.testing.assert_allclose(tw[hit], tj[hit], rtol=2e-4)
    real = (cw[hit] != cj[hit]) & (np.abs(tw[hit] - tj[hit]) > 1e-4 * tw[hit])
    assert real.mean() < 0.002
