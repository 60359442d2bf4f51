"""`walk_reference`, the BVH-following plain version of the warp-per-ray
CUDA kernels (`nearest_kernel`, `anyhit_kernel`), on the CPU: against the
dense plain versions, against spray_tpu's fused Pallas path (interpret mode)
on identical cluster pages and rays, and piece by piece (push order, packet
widths, cluster size 64, dead lanes, -0.0 keys, stack high-water)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.io import scenes as js
from spray_tpu.kernels import multidomain as jmd
from spray_tpu_torch.interop import scene_from_arrays
from spray_tpu_torch.kernels import multidomain as tmd
from spray_tpu_torch.kernels import traverse
from spray_tpu_torch.kernels.common import pad_rays

SCENES = {
    "cornell": (lambda: js.cornell_box(), 1, 1),
    "sphere": (lambda: js.bumpy_sphere(subdiv=3), 2, 2),
    "wisps": (lambda: js.wisp_cloud(n_blobs=8, tris_per_blob=80, extent=4.0), 6, 3),
}
N_RAYS = 300  # two packets of 256, the second partly padding


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
        scene_from_arrays(scene.vertices, scene.faces, scene.albedo,
                          scene.emission), pages, device="cpu", **kw)


def _wave(scene, seed, n=N_RAYS):
    """Random rays with dead lanes; (o, d, tmin, tmax, far) numpy."""
    o, d = _rand_rays(scene, n, seed)
    tmax = np.full(n, np.inf, np.float32)
    tmax[::7] = 0.0  # dead lanes: empty windows
    return o, d, np.zeros(n, np.float32), tmax, np.full(n, 1e30, np.float32)


def _assert_codes_equal_off_ties(args, t, code_walk, code_dense):
    """Codes differ only where both triangles hit inside the ray's 128-ulp
    key quantum (the visit order breaks that tie)."""
    _, o, d, tmin, tmax, _, _, w, _ = args
    nc, c = w.shape[1], w.shape[3] // 3
    for i in torch.nonzero(code_walk != code_dense).view(-1).tolist():
        for code in (int(code_walk[i]), int(code_dense[i])):
            assert code >= 0
            dom, cid, row = code // (nc * c), code // c % nc, code % c
            key = traverse._dense_keys(o[i:i + 1], d[i:i + 1], tmin[i:i + 1],
                                       tmax[i:i + 1], w[dom], cid, cid + 1,
                                       False)[0, row]
            t_up = ((key & -128) + 128).view(torch.float32)
            assert t_up == t[i], f"ray {i}: code {code} is no tie"


@pytest.mark.parametrize("name", sorted(SCENES))
def test_walk_equals_dense_plain_versions(name):
    """Same t bit for bit, same occlusion, codes equal off ties; the counts
    are consistent (C tests per leaf visit)."""
    make, n_domains, seed = SCENES[name]
    scene = make()
    px = _port(scene, jmd.build_cluster_domains(scene, n_domains))
    o, d, tmin, tmax, far = (torch.as_tensor(a) for a in _wave(scene, seed))
    args, _ = px._args(o, d, tmin, tmax)
    t_w, code_w, cnt = traverse.walk_reference(*args[:-1])
    t_d, code_d = traverse.nearest_reference(*args[:-1])
    np.testing.assert_array_equal(t_w.numpy().view(np.int32),
                                  t_d.numpy().view(np.int32))
    np.testing.assert_array_equal((code_w >= 0).numpy(), (code_d >= 0).numpy())
    _assert_codes_equal_off_ties(args[:-1], t_w, code_w, code_d)
    assert (code_w != code_d).float().mean() < 0.01
    c = px.w.shape[3] // 3
    assert cnt["nodes"] > 0 and cnt["tests"] == cnt["leaves"] * c
    args, _ = px._args(o, d, tmin, far)
    occ_w, cnt = traverse.walk_reference(*args[:-1], occl=True)
    occ_d = traverse.anyhit_reference(*args[:-1])
    np.testing.assert_array_equal(occ_w.numpy(), occ_d.numpy())
    assert cnt["tests"] == cnt["leaves"] * c


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
def test_walk_matches_fused_pallas(name):
    """spray_tpu's routed="fused" intersector (the Pallas fused nearest and
    any-hit kernels in interpret mode) against `walk_reference` fed from the
    port intersector's packed arguments, its codes mapped through tri_ids."""
    make, n_domains, seed = SCENES[name]
    scene = make()
    o, d, tmin, tmax, far = _wave(scene, seed)
    jx = jmd.MultiDomainClusterIntersector(
        scene, n_domains=n_domains, routed="fused", interpret=True)
    px = _port(scene, jmd.build_cluster_domains(scene, n_domains))
    args_j = [jnp.asarray(a) for a in (o, d, tmin, tmax)]
    o_t, d_t, tmin_t, tmax_t, far_t = (torch.as_tensor(a)
                                       for a in (o, d, tmin, tmax, far))
    args, inv = px._args(o_t, d_t, tmin_t, tmax_t)
    t, code, _ = traverse.walk_reference(*args[:-1])
    ht = px._hits(o_t, d_t, tmax_t, args, inv, t, code)
    _assert_hits_close(jx.intersect(*args_j), ht)
    # occlusion: strict (0, tmax) windows, exactly equal
    args, inv = px._args(o_t, d_t, tmin_t, far_t)
    occ, _ = traverse.walk_reference(*args[:-1], occl=True)
    occ_j = np.asarray(jx.occluded(args_j[0], args_j[1], jnp.asarray(far)))
    np.testing.assert_array_equal(occ[: len(o)][inv].numpy() != 0, occ_j)


def _insertion_sort_push(te, hit):
    """The per-thread kernel's node step: stable insertion sort of the hit
    children by entry t, pushed in reverse.  Returns the pushed slots, bottom
    of the stack first."""
    ct, cm = [], []
    for j in range(8):
        if not hit[j]:
            continue
        q = len(ct)
        ct.append(te[j])
        cm.append(j)
        while q > 0 and ct[q - 1] > te[j]:
            ct[q], cm[q] = ct[q - 1], cm[q - 1]
            q -= 1
        ct[q], cm[q] = te[j], j
    return cm[::-1]


def test_rank_push_equals_stable_insertion_sort():
    rs = np.random.RandomState(5)
    for _ in range(500):
        # few distinct values: ties in most nodes; some children missed
        te = rs.choice(np.float32([0.0, 0.5, 0.5, 1.25, 3.0]), 8)
        hit = rs.uniform(size=8) < 0.7
        rank = traverse.child_ranks(te, hit)
        k = int(hit.sum())
        assert (rank[~hit] == -1).all()
        assert sorted(rank[hit].tolist()) == list(range(k))
        pushed = np.full(k, -1)
        pushed[k - 1 - rank[hit]] = np.nonzero(hit)[0]
        assert pushed.tolist() == _insertion_sort_push(te, hit)


def _per_ray(px, o, d, tmin, tmax, occl):
    """walk_reference through px's packing, back in the caller's ray order."""
    args, inv = px._args(o, d, tmin, tmax)
    out = traverse.walk_reference(*args[:-1], occl=occl)
    return [x[: o.shape[0]][inv] for x in out[:-1]], out[-1]


def test_packet_widths_agree():
    scene = SCENES["wisps"][0]()
    pages = jmd.build_cluster_domains(scene, 6)
    n = 260
    o, d = map(torch.as_tensor, _rand_rays(scene, n, 7))
    tmin, tmax = torch.zeros(n), torch.full((n,), float("inf"))
    far = torch.full((n,), 1e30)
    near = [_per_ray(_port(scene, pages, packet=p), o, d, tmin, tmax, False)[0]
            for p in (128, 256, 512)]
    occs = [_per_ray(_port(scene, pages, packet=p), o, d, tmin, far, True)[0]
            for p in (128, 256, 512)]
    for (t, code), (occ,) in zip(near[1:], occs[1:]):
        np.testing.assert_array_equal(t.numpy(), near[0][0].numpy())
        np.testing.assert_array_equal(code.numpy(), near[0][1].numpy())
        np.testing.assert_array_equal(occ.numpy(), occs[0][0].numpy())


def test_cluster_64_equals_dense():
    """C = 64: two 32-row strides per leaf instead of four."""
    scene = SCENES["wisps"][0]()
    pages = jmd.build_cluster_domains(scene, 6, cluster=64)
    assert pages["w"].shape[-1] == 3 * 64
    px = _port(scene, pages)
    o, d, tmin, tmax, _ = (torch.as_tensor(a) for a in _wave(scene, 11, 256))
    args, _ = px._args(o, d, tmin, tmax)
    t_w, code_w, cnt = traverse.walk_reference(*args[:-1])
    t_d, code_d = traverse.nearest_reference(*args[:-1])
    np.testing.assert_array_equal(t_w.numpy(), t_d.numpy())
    _assert_codes_equal_off_ties(args[:-1], t_w, code_w, code_d)
    assert cnt["tests"] == cnt["leaves"] * 64


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


def test_dead_lanes_and_negative_zero_keys():
    """A ray starting ON the triangle has t = -0.0: key 0 (t_up = 128 ulp),
    not INT_MIN; the strict occlusion gate does not count it.  Dead lanes
    (tmax <= 0, the padding among them) keep tmax, code -1, occlusion 0 and
    cost no visit."""
    pages = _one_triangle_pages()
    o = np.float32([(0.25, 0.25, 0.0), (0.25, 0.25, 1.0), (0.25, 0.25, 1.0)])
    d = np.float32([(0, 0, 1), (0, 0, -1), (0, 0, -1)])
    tmax = np.float32([10, 10, 0])
    rays = pad_rays(*(torch.as_tensor(a) for a in (o, d, np.zeros(3, np.float32),
                                                    tmax)), 256)
    order = torch.zeros((1, 1), dtype=torch.int32)
    t, code, cnt = traverse.walk_reference(order, *rays, *pages, 256)
    np.testing.assert_array_equal(code[:3].numpy(), [5, 5, -1])
    assert t[0].item() == np.frombuffer(np.int32(128).tobytes(), np.float32)[0]
    assert t[2].item() == 0.0 and (code[3:] == -1).all()
    assert cnt == {"nodes": 2, "leaves": 2, "tests": 256, "stack_high": 1}
    occ, cnt = traverse.walk_reference(order, *rays, *pages, 256, occl=True)
    np.testing.assert_array_equal(occ[:3].numpy(), [0, 1, 0])
    assert (occ[3:] == 0).all() and cnt["leaves"] == 2
    t_d, code_d = traverse.nearest(order, *rays, *pages, packet=256, depth=1)
    np.testing.assert_array_equal(t.numpy(), t_d.numpy())
    np.testing.assert_array_equal(code.numpy(), code_d.numpy())


def test_stack_high_water_within_host_bound():
    """The host's launch check 7 * depth + 1 bounds what any ray pushes; a
    smaller stack than the walk needs raises."""
    scene = SCENES["wisps"][0]()
    px = _port(scene, jmd.build_cluster_domains(scene, 2))
    o, d, tmin, tmax, _ = (torch.as_tensor(a) for a in _wave(scene, 3))
    args, _ = px._args(o, d, tmin, tmax)
    _, _, cnt = traverse.walk_reference(*args[:-1])
    assert 1 < cnt["stack_high"] <= 7 * px.depth + 1
    with pytest.raises(ValueError):
        traverse.walk_reference(*args[:-1], stack=cnt["stack_high"] - 1)


def test_one_entry_lists_equal_slot_reference():
    """The walk over one-entry lists, its code less the domain offset, is
    the slot kernel's contract on live packets (how the two CUDA designs are
    held against each other on the card)."""
    scene = SCENES["wisps"][0]()
    px = _port(scene, jmd.build_cluster_domains(scene, 6))
    o, d, tmin, tmax, _ = (torch.as_tensor(a) for a in _wave(scene, 13))
    (order, *rest), _ = px._args(o, d, tmin, tmax)
    rest = rest[:-1]
    for r in range(2):
        bucket = order[:, r].contiguous()
        assert (bucket >= 0).all()
        t_w, code_w, _ = traverse.walk_reference(bucket[:, None], *rest)
        t_s, code_s = traverse.nearest_slot_reference(bucket, *rest)
        dom = bucket.repeat_interleave(px.packet)
        local = torch.where(code_w >= 0, code_w - dom * px.per_dom, -1)
        np.testing.assert_array_equal(t_w.numpy(), t_s.numpy())
        assert ((local >= 0) == (code_s >= 0)).all()
        glob = torch.where(code_s >= 0, code_s + dom * px.per_dom, -1)
        _assert_codes_equal_off_ties((bucket[:, None], *rest), t_w, code_w,
                                     glob)
        assert (local != code_s).float().mean() < 0.01
