"""Every `routed` mode of the port's multi-domain intersector (plain kernel
versions, on the CPU) == the reference's intersector of the same mode
(Pallas in interpret mode) on identical pages, and == the port's "fused"
mode; the port's fused any-hit == its per-round grid form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.io import scenes as js
from spray_tpu.kernels import multidomain as jmd
from spray_tpu_torch.interop import scene_from_arrays
from spray_tpu_torch.kernels import multidomain as tmd
from spray_tpu_torch.kernels import traverse
from spray_tpu_torch.oracle.brute import BruteIntersector as TBrute

MODES = ["fused", "grid", "global", True, False]
N_DOMAINS = 6
N = 1500


def _port_scene(s):
    return scene_from_arrays(s.vertices, s.faces, s.albedo, s.emission)


@pytest.fixture(scope="module")
def case():
    """The scene and rays of tests/test_kernels_traverse.py's multi-domain
    test, with dead lanes and a dead packet added; the port's fused result
    computed once."""
    scene = js.wisp_cloud(n_blobs=8, tris_per_blob=80, extent=4.0)
    v = np.asarray(scene.vertices)
    rs = np.random.RandomState(5)
    o = rs.uniform(v.min(0) - 0.5, v.max(0) + 0.5, (N, 3)).astype(np.float32)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(N, np.float32)
    tmax = np.full(N, np.inf, np.float32)
    tmax[::9] = 0.0
    tmax[300:600] = 0.0  # more than one packet's worth of dead lanes
    far = np.where(tmax > 0, 1e30, 0.0).astype(np.float32)
    pages = jmd.build_cluster_domains(scene, N_DOMAINS)
    rays = (o, d, tmin, tmax)
    fused = tmd.MultiDomainClusterIntersector.from_pages(
        _port_scene(scene), pages, device="cpu")
    tr = [torch.as_tensor(x) for x in rays]
    hits = fused.intersect(*tr)
    occ = fused.occluded(tr[0], tr[1], torch.as_tensor(far))
    return scene, pages, rays, far, hits, occ


@pytest.mark.parametrize("routed", MODES, ids=[str(m) for m in MODES])
def test_routed_mode_matches_reference_and_fused(case, routed):
    scene, pages, rays, far, hf, occ_f = case
    ji = jmd.MultiDomainClusterIntersector(scene, n_domains=N_DOMAINS,
                                           routed=routed, interpret=True)
    ti = tmd.MultiDomainClusterIntersector.from_pages(
        _port_scene(scene), pages, device="cpu", routed=routed)
    jr = [jnp.asarray(x) for x in rays]
    tr = [torch.as_tensor(x) for x in rays]
    hj, ht = ji.intersect(*jr), ti.intersect(*tr)
    occ_j = np.asarray(ji.occluded(jr[0], jr[1], jnp.asarray(far)))
    occ_t = ti.occluded(tr[0], tr[1], torch.as_tensor(far))
    # against the reference: masks equal; t to the rtol 2e-4 / atol 2e-5 of
    # tests/test_kernels_traverse.py (split-bf16 against f32 transforms)
    valid = np.asarray(hj.valid)
    np.testing.assert_array_equal(ht.valid.numpy(), valid)
    np.testing.assert_allclose(ht.t.numpy()[valid], np.asarray(hj.t)[valid],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    # across the port's modes: everything equal, bit for bit
    assert torch.equal(ht.valid, hf.valid) and torch.equal(ht.prim, hf.prim)
    assert torch.equal(ht.t, hf.t) and torch.equal(occ_t, occ_f)
    assert torch.equal(ht.u, hf.u) and torch.equal(ht.v, hf.v)
    assert valid.any() and occ_j.any() and not valid[rays[3] == 0].any()


def test_routed_modes_match_brute_oracle(case):
    scene, pages, rays, far, hf, occ_f = case
    tr = [torch.as_tensor(x) for x in rays]
    brute = TBrute(_port_scene(scene), device="cpu")
    hb = brute.intersect(*tr)
    assert torch.equal(hb.valid, hf.valid)
    m = hb.valid
    torch.testing.assert_close(hf.t[m], hb.t[m], rtol=2e-4, atol=2e-5)
    assert torch.equal(brute.occluded(tr[0], tr[1], torch.as_tensor(far)), occ_f)


def test_fused_anyhit_matches_grid():
    """The inputs of tests/test_multidomain.py::test_fused_anyhit_matches_grid
    (every fourth ray dead): one launch over the whole list == one launch
    per round, and both == the reference's two forms."""
    from spray_tpu.kernels.traverse import _rays_to_aug

    scene = js.wisp_cloud(n_blobs=6, tris_per_blob=200, extent=4.0, seed=5)
    ji = jmd.MultiDomainClusterIntersector(scene, n_domains=6, interpret=True)
    rs = np.random.RandomState(3)
    n = 600
    o = rs.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(n) % 4 == 0, 0.0, 6.0).astype(np.float32)
    tmin = np.zeros(n, np.float32)
    aug, _ = _rays_to_aug(*map(jnp.asarray, (o, d, tmin, tmax)), 256)
    jf = np.asarray(jmd._routed_anyhit_fused(
        ji.bounds, ji.meta, ji.w, ji.dom_aabb, aug, True))[:n] != 0
    jg = np.asarray(jmd._routed_anyhit_grid(
        ji.bounds, ji.meta, ji.w, ji.dom_aabb, aug, True))[:n] != 0

    pages = jmd.build_cluster_domains(scene, 6)
    ti = tmd.MultiDomainClusterIntersector.from_pages(
        _port_scene(scene), pages, device="cpu")
    # the reference's call keeps the rays in the caller's order: so here
    from spray_tpu_torch.kernels.common import pad_rays
    rays = pad_rays(*map(torch.as_tensor, (o, d, tmin, tmax)), ti.packet)
    order, _ = tmd._packet_domain_order(*rays, ti.dom_aabb, ti.packet)
    args = (order, *rays, ti.bounds, ti.meta, ti.w, ti.packet, ti.depth)
    tf = ti._routed_anyhit_fused(args)[:n] != 0
    tg = ti._rounds_anyhit(args)[:n] != 0  # the loop of routed="grid"
    assert torch.equal(tf, tg)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tg.numpy(), jg)
    assert tf.any() and not tf[tmax == 0].any()


def test_routed_rejects_unknown_mode_and_counts_rounds(case, monkeypatch):
    scene, pages, rays, far, _, _ = case
    with pytest.raises(ValueError, match="routed"):
        tmd.MultiDomainClusterIntersector.from_pages(
            _port_scene(scene), pages, device="cpu", routed="banana")
    # per-round modes launch the slot kernel's wrapper once per round, the
    # scan once per domain; any-hit likewise on one-entry lists
    calls = {"slot": 0, "any": []}
    slot, anyhit = traverse.nearest_slot, traverse.anyhit

    def count_slot(*a, **k):
        calls["slot"] += 1
        return slot(*a, **k)

    def count_any(order, *a, **k):
        calls["any"].append(order.shape[1])
        return anyhit(order, *a, **k)

    monkeypatch.setattr(traverse, "nearest_slot", count_slot)
    monkeypatch.setattr(traverse, "anyhit", count_any)
    tr = [torch.as_tensor(x) for x in rays]
    for routed in ("grid", False):
        ti = tmd.MultiDomainClusterIntersector.from_pages(
            _port_scene(scene), pages, device="cpu", routed=routed)
        calls["slot"], calls["any"] = 0, []
        ti.intersect(*tr)
        ti.occluded(tr[0], tr[1], torch.as_tensor(far))
        assert calls["slot"] == N_DOMAINS
        assert calls["any"] == [1] * N_DOMAINS
