"""spray_tpu_torch multi-domain traversal (plain versions of the CUDA
kernels, on the CPU) == spray_tpu's fused Pallas path (interpret mode) and
the brute oracle, on identical cluster pages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.io import scenes as js
from spray_tpu.kernels import multidomain as jmd
from spray_tpu.kernels.traverse import _rays_to_aug
from spray_tpu.oracle.brute import BruteIntersector as JBrute
from spray_tpu_torch.interop import scene_from_arrays
from spray_tpu_torch.kernels import _build, traverse
from spray_tpu_torch.kernels.common import pad_rays
from spray_tpu_torch.kernels import multidomain as tmd
from spray_tpu_torch.oracle.brute import BruteIntersector as TBrute

SCENES = {
    "cornell": (lambda: js.cornell_box(), 1, 1),
    "sphere": (lambda: js.bumpy_sphere(subdiv=3), 2, 2),
    "wisps": (lambda: js.wisp_cloud(n_blobs=8, tris_per_blob=80, extent=4.0), 6, 3),
}


def _port_scene(s):
    return scene_from_arrays(s.vertices, s.faces, s.albedo, s.emission)


def _rand_rays(scene, n, seed):
    v = np.asarray(scene.vertices)
    lo, hi = v.min(0), v.max(0)
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _port(scene, pages, **kw):
    return tmd.MultiDomainClusterIntersector.from_pages(
        _port_scene(scene), pages, device="cpu", **kw)


def _assert_hits_close(ref, got):
    """The bar of tests/test_kernels_traverse.py."""
    valid_r, valid_g = (np.asarray(h.valid) for h in (ref, got))
    np.testing.assert_array_equal(valid_r, valid_g)
    m = valid_r
    tr, tg = np.asarray(ref.t)[m], np.asarray(got.t)[m]
    np.testing.assert_allclose(tg, tr, rtol=2e-4, atol=2e-5)
    mismatch = np.asarray(ref.prim)[m] != np.asarray(got.prim)[m]
    real = mismatch & (np.abs(tr - tg) > 1e-4 * np.maximum(tr, 1))
    assert real.mean() < 0.002, f"non-tie prim mismatch {real.mean():.4f}"


@pytest.mark.parametrize("name", sorted(SCENES))
def test_port_matches_fused_pallas_and_brute(name):
    make, n_domains, seed = SCENES[name]
    scene = make()
    n = 1500  # several packets, not a multiple of the packet width
    o, d = _rand_rays(scene, n, seed)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[::7] = 0.0  # dead lanes: empty windows
    far = np.full(n, 1e30, np.float32)
    jx = jmd.MultiDomainClusterIntersector(
        scene, n_domains=n_domains, routed="fused", interpret=True)
    pages = jmd.build_cluster_domains(scene, n_domains)
    px = _port(scene, pages)
    args_j = [jnp.asarray(a) for a in (o, d, tmin, tmax)]
    args_t = [torch.as_tensor(a) for a in (o, d, tmin, tmax)]
    hj = jx.intersect(*args_j)
    hb = JBrute(scene, jnp).intersect(*args_j)
    ht = px.intersect(*args_t)
    _assert_hits_close(hj, ht)
    _assert_hits_close(hb, ht)
    # occlusion: strict (0, tmax) windows, exactly equal
    occ_j = np.asarray(jx.occluded(args_j[0], args_j[1], jnp.asarray(far)))
    occ_b = np.asarray(JBrute(scene, jnp).occluded(args_j[0], args_j[1],
                                                  jnp.asarray(far)))
    occ_t = px.occluded(args_t[0], args_t[1], torch.as_tensor(far)).numpy()
    np.testing.assert_array_equal(occ_t, occ_j)
    np.testing.assert_array_equal(occ_t, occ_b)
    # the torch brute oracle is the reference's brute oracle
    tb = TBrute(_port_scene(scene), device="cpu").intersect(*args_t)
    np.testing.assert_array_equal(tb.prim.numpy(), np.asarray(hb.prim))
    np.testing.assert_allclose(tb.t.numpy(), np.asarray(hb.t), rtol=1e-6)


def test_live_partition_and_domain_order_equal():
    scene = SCENES["wisps"][0]()
    pages = jmd.build_cluster_domains(scene, 6)
    n = 1100
    o, d = _rand_rays(scene, n, 9)
    rs = np.random.RandomState(4)
    tmax = np.where(rs.uniform(size=n) < 0.3, 0.0, 6.0).astype(np.float32)
    tmin = np.zeros(n, np.float32)
    aabb = pages["aabb"]
    lo, hi = aabb[:, 0:3].min(0), aabb[:, 3:6].max(0)
    pj, ij = jmd._live_partition(jnp.asarray(tmax), jnp.asarray(d),
                                 jnp.asarray(o), jnp.asarray(lo), jnp.asarray(hi))
    pt, it = tmd._live_partition(torch.as_tensor(tmax), torch.as_tensor(d),
                                 torch.as_tensor(o), torch.as_tensor(lo),
                                 torch.as_tensor(hi))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    perm = pt.numpy()
    for packet in (128, 256):
        aug, _ = _rays_to_aug(*(jnp.asarray(a[perm]) for a in (o, d, tmin, tmax)),
                              packet)
        oj, ej = jmd._packet_domain_order(aug, jnp.asarray(aabb))
        rays = pad_rays(*(torch.as_tensor(a[perm]) for a in (o, d, tmin, tmax)),
                             packet)
        # the padding rays: d = 1, tmin = 1, tmax = 0 (an empty window)
        assert (rays[1][n:] == 1).all() and (rays[2][n:] == 1).all()
        assert (rays[3][n:] == 0).all()
        ot, et = tmd._packet_domain_order(*rays, torch.as_tensor(aabb), packet)
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


def test_packet_widths_agree():
    scene = SCENES["wisps"][0]()
    pages = jmd.build_cluster_domains(scene, 6)
    n = 700
    o, d = map(torch.as_tensor, _rand_rays(scene, n, 7))
    tmin = torch.zeros(n)
    tmax = torch.full((n,), float("inf"))
    hits = [_port(scene, pages, packet=p).intersect(o, d, tmin, tmax)
            for p in (128, 256, 512)]
    occs = [_port(scene, pages, packet=p).occluded(o, d, torch.full((n,), 1e30))
            for p in (128, 256, 512)]
    for h, oc in zip(hits[1:], occs[1:]):
        np.testing.assert_array_equal(h.valid.numpy(), hits[0].valid.numpy())
        np.testing.assert_array_equal(h.prim.numpy(), hits[0].prim.numpy())
        np.testing.assert_allclose(h.t.numpy(), hits[0].t.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(oc.numpy(), occs[0].numpy())


def test_cluster_64_matches_brute():
    scene = SCENES["wisps"][0]()
    pages = jmd.build_cluster_domains(scene, 6, cluster=64)
    assert pages["w"].shape[-1] == 3 * 64
    n = 900
    o, d = _rand_rays(scene, n, 11)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    ht = _port(scene, pages).intersect(*map(torch.as_tensor, (o, d, tmin, tmax)))
    hb = JBrute(scene, jnp).intersect(*map(jnp.asarray, (o, d, tmin, tmax)))
    _assert_hits_close(hb, ht)


def _one_triangle_pages():
    """One domain, one cluster of C=128 rows; row 5 is the triangle
    (0,0,0) (1,0,0) (0,1,0), the other rows never hit."""
    from spray_tpu_torch.kernels.cluster_bvh import tri_transforms

    c = 128
    v0 = np.zeros((c, 3), np.float32)
    e1 = np.zeros((c, 3), np.float32)
    e2 = np.zeros((c, 3), np.float32)
    e1[5] = (1, 0, 0)
    e2[5] = (0, 1, 0)
    tf = tri_transforms(v0, e1, e2).reshape(1, c, 4, 3)
    w = np.transpose(tf, (0, 2, 3, 1)).reshape(1, 1, 4, 3 * c)
    bounds = np.zeros((1, 1, 8, 6), np.float32)
    bounds[0, 0, 0] = (0, 0, 0, 1, 1, 0)
    meta = np.full((1, 1, 8), -1, np.int32)
    meta[0, 0, 0] = -2  # leaf: cluster 0
    return [torch.as_tensor(x) for x in (bounds, meta, w)]


def _trace(o, d, tmin, tmax, occl=False):
    pages = _one_triangle_pages()
    n = len(o)
    rays = pad_rays(*(torch.as_tensor(np.asarray(a, np.float32))
                           for a in (o, d, tmin, tmax)), 256)
    order = torch.zeros((rays[0].shape[0] // 256, 1), dtype=torch.int32)
    fn = traverse.anyhit if occl else traverse.nearest
    out = fn(order, *rays, *pages, packet=256, depth=1)
    return [x[:n] for x in out] if not occl else out[:n]


def test_zero_t_keys_clamp_negative_zero():
    """A ray starting ON the triangle has t = -ow/dw = -0.0: it must pack as
    key 0 (a hit at t_up = 128 ulp), not as INT_MIN, which would hide every
    real hit; the strict occlusion gate (t > tmin) must not count it."""
    o = [(0.25, 0.25, 0.0), (0.25, 0.25, 1.0)]
    d = [(0.0, 0.0, 1.0), (0.0, 0.0, -1.0)]
    t, code = _trace(o, d, [0, 0], [10, 10])
    np.testing.assert_array_equal(code.numpy(), [5, 5])
    assert t[0].item() == np.frombuffer(np.int32(128).tobytes(), np.float32)[0]
    occ = _trace(o, d, [0, 0], [10, 10], occl=True)
    np.testing.assert_array_equal(occ.numpy(), [0, 1])


def test_t_rounded_up_and_windows():
    """t comes back rounded UP to the 128-ulp key quantum (windows only
    widen); a hit at or beyond the window's end is not taken; dead lanes
    (tmax = 0) never hit."""
    rs = np.random.RandomState(0)
    n = 300
    o = np.c_[rs.uniform(0.05, 0.4, n), rs.uniform(0.05, 0.4, n),
              rs.uniform(0.1, 9.0, n)].astype(np.float32)
    d = np.tile(np.float32([0, 0, -1]), (n, 1))
    tmax = np.full(n, 100.0, np.float32)
    tmax[:50] = o[:50, 2]  # window ends exactly at the hit
    tmax[50:60] = 0.0
    t, code = _trace(o, d, np.zeros(n), tmax)
    true_t = o[:, 2]
    hit = code.numpy() == 5
    assert not hit[:60].any() and hit[60:].all()
    tt = t.numpy()[60:]
    bits = true_t[60:].view(np.int32)
    np.testing.assert_array_equal(tt.view(np.int32), (bits & -128) + 128)
    assert (tt >= true_t[60:]).all()
    np.testing.assert_array_equal(t.numpy()[:60], tmax[:60])


def test_ctypes_signatures_take_pointers_as_void_p():
    """Every pointer (and the stream) goes through c_void_p: a plain int
    argtype would cut 64-bit device pointers to 32 bits."""
    import ctypes

    ptr_pos = {"spray_nearest": [0, 3, 4, 5, 6, 8, 9, 10, 14, 15, 16, 17],
               "spray_anyhit": [0, 3, 4, 5, 6, 8, 9, 10, 14, 15, 16]}
    for fn, pos in ptr_pos.items():
        sig = _build._SIGNATURES[fn]
        assert [i for i, a in enumerate(sig) if a is ctypes.c_void_p] == pos
    for fn in ("spray_nearest", "spray_anyhit"):
        assert f"int {fn}(" in (_build.CSRC / "traverse.cu").read_text()


def test_wrappers_reject_bad_inputs():
    pages = _one_triangle_pages()
    rays = [torch.zeros(256, 3), torch.ones(256, 3), torch.zeros(256),
            torch.ones(256)]
    order = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        traverse.nearest(order.long(), *rays, *pages, packet=256, depth=1)
    with pytest.raises(ValueError):
        traverse.nearest(order, *rays, *pages, packet=128, depth=1)
    with pytest.raises(ValueError):
        traverse.anyhit(order, rays[0].t(), *rays[1:], *pages, packet=256,
                        depth=1)
    before = dict(traverse.launches)
    traverse.nearest(order, *rays, *pages, packet=256, depth=1)
    assert traverse.launches == before  # the plain version never counts
