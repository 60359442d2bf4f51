"""The port's per-rank pieces of spray_tpu.dist that run no collective,
against the reference's on the same pages, domain sets and rays: the two
local traces of the in-situ renderer (`_local_trace_cluster`, one kernel
launch per resident page; `_local_trace`, the BVH walk), the padded pixel
ids, and `_insitu_setup`'s per-rank slices, owner map and boxes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.dist import epochs as jep
from spray_tpu.dist import rayshard as jrs
from spray_tpu.domains.partition import partition_scene as j_partition
from spray_tpu.io.scenes import wisp_cloud
from spray_tpu.kernels.multidomain import build_cluster_domains as j_pages
from spray_tpu.kernels.traverse import stack_w_pages
from spray_tpu.sched.epochs import EpochState as JState
from spray_tpu.sched.epochs import needed_mask as j_needed_mask
from spray_tpu_torch.core.camera import make_camera
from spray_tpu_torch.dist import epochs as tep
from spray_tpu_torch.dist import rayshard as trs
from spray_tpu_torch.interop import scene_from_arrays
from spray_tpu_torch.kernels import traverse
from spray_tpu_torch.sched.multidomain import BVH_FIELDS, nearest_needed, needed

SCENE = wisp_cloud(n_blobs=8, tris_per_blob=80, extent=4.0, seed=11)
TSCENE = scene_from_arrays(SCENE.vertices, SCENE.faces, SCENE.albedo,
                           SCENE.emission)
N = 1000  # several packets, not a multiple of the packet width
CPU = torch.device("cpu")


def _rays(seed, far, aim=None):
    """Random rays over the scene box, or aimed at random points of the box
    `aim` (lo, hi); every 7th lane has an empty window (a dead lane), and
    lanes 256-511 (the second packet) all do."""
    v = np.asarray(SCENE.vertices)
    rs = np.random.RandomState(seed)
    o = rs.uniform(v.min(0) - 1, v.max(0) + 1, (N, 3)).astype(np.float32)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    if aim is not None:
        d = (rs.uniform(aim[0], aim[1], (N, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    win = np.full(N, far, np.float32)
    win[::7] = 0.0
    win[256:512] = 0.0
    return o, d, np.zeros(N, np.float32), win


@pytest.fixture(scope="module")
def pages():
    """The reference's 8 cluster pages, and a 2-page set whose second page
    is the first one again with its global ids shifted past the scene's:
    every hit there is an exact tie between the two pages."""
    st = j_pages(SCENE, 8)
    dup = {k: np.stack([st[k][0], st[k][0]]) for k in ("bounds", "meta", "w",
                                                       "tri_ids")}
    dup["tri_ids"][1] = np.where(dup["tri_ids"][1] >= 0,
                                 dup["tri_ids"][1] + SCENE.faces.shape[0], -1)
    return {"all": st, "tie": dup}


def _ref_cluster(st, rays, any_hit):
    jp = {k: jnp.asarray(st[k]) for k in ("bounds", "meta", "tri_ids")}
    jp["w"] = stack_w_pages(jnp.asarray(st["w"]))
    out = jep._local_trace_cluster(jp, *map(jnp.asarray, rays), any_hit, True)
    return [np.asarray(x) for x in out]


def _port_cluster(st, rays, any_hit):
    tp = {k: torch.as_tensor(st[k]) for k in ("bounds", "meta", "w")}
    tp["tri_ids"] = torch.as_tensor(np.asarray(st["tri_ids"], np.int64))
    out = tep._local_trace_cluster(tp, traverse.tree_depth(st["meta"]),
                                   *map(torch.as_tensor, rays), any_hit)
    return [x.numpy() for x in out]


def _assert_close(ref, got, any_hit):
    """found / occlusion equal, t within rtol 2e-4, prims equal up to ties
    (the bar of tests/test_kernels_traverse.py)."""
    (tr, pr, fr), (tg, pg, fg) = ref, got
    np.testing.assert_array_equal(fg, fr)
    if any_hit:
        np.testing.assert_array_equal(tg, tr)  # the window, untouched
        return
    np.testing.assert_allclose(tg[fr], tr[fr], rtol=2e-4, atol=2e-5)
    mism = (pg[fr] != pr[fr]) & (np.abs(tr[fr] - tg[fr]) > 1e-4 * np.maximum(tr[fr], 1))
    assert mism.mean() < 0.002, f"non-tie prim mismatch {mism.mean():.4f}"
    np.testing.assert_array_equal(pg[~fr], -1)


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "anyhit"])
def test_local_trace_cluster_matches_reference(pages, any_hit):
    rays = _rays(3, 1e30 if any_hit else np.inf)
    ref = _ref_cluster(pages["all"], rays, any_hit)
    got = _port_cluster(pages["all"], rays, any_hit)
    _assert_close(ref, got, any_hit)
    dead = rays[3] == 0
    assert not got[2][dead].any() and got[2].any() and not got[2].all()


def test_local_trace_cluster_tie_goes_to_the_first_page(pages):
    """Two pages with the same triangles: the strict update keeps the first
    page's prim on every hit, in both packages."""
    box = pages["all"]["aabb"][0]
    rays = _rays(5, np.inf, aim=(box[0:3], box[3:6]))
    ref = _ref_cluster(pages["tie"], rays, False)
    got = _port_cluster(pages["tie"], rays, False)
    _assert_close(ref, got, False)
    hit = got[2]
    assert hit.sum() > 200
    np.testing.assert_array_equal(got[1][hit], ref[1][hit])
    assert (got[1][hit] < SCENE.faces.shape[0]).all()


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "anyhit"])
def test_local_trace_cluster_launches_through_the_wrappers(pages, monkeypatch,
                                                           any_hit):
    """One launch a page, looked up on `kernels.traverse` at each call: a
    recorder installed there (chip_smoke.py's `SlotRecorder`) sees every
    page, with the window the launch got."""
    name = "anyhit" if any_hit else "nearest_slot"
    inner, windows = getattr(traverse, name), []

    def record(order, o, d, tmin, tmax, *rest, **kw):
        windows.append(tmax.clone())
        return inner(order, o, d, tmin, tmax, *rest, **kw)

    monkeypatch.setattr(traverse, name, record)
    rays = _rays(3, 1e30 if any_hit else np.inf)
    _port_cluster(pages["all"], rays, any_hit)
    assert len(windows) == pages["all"]["w"].shape[0]
    dead = np.concatenate([rays[3] == 0, np.ones(len(windows[0]) - N, bool)])
    assert all(not w.numpy()[dead].any() for w in windows)


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "anyhit"])
def test_local_trace_bvh_matches_reference(any_hit):
    """The "jnp" backend's local trace: per-domain BVH walks in order."""
    dset = j_partition(SCENE, 4, leaf_size=8)
    rays = _rays(7, 1e30 if any_hit else np.inf)
    jl = {k: jnp.asarray(getattr(dset, k)) for k in BVH_FIELDS}
    ref = [np.asarray(x) for x in jep._local_trace(
        jl, 8, *map(jnp.asarray, rays), any_hit)]
    tl = {k: torch.as_tensor(getattr(dset, k)) for k in BVH_FIELDS}
    got = [x.numpy() for x in tep._local_trace(
        tl, 8, *map(torch.as_tensor, rays), any_hit)]
    _assert_close(ref, got, any_hit)
    if any_hit:  # the prim of the hit that occluded the ray
        np.testing.assert_array_equal(got[1], ref[1])


def _rule_inputs(seed):
    """(entry_t, processed, best_t, found) of 64 rays over 16 domains:
    entries drawn from four values (exact ties between domains), four rows
    that overlap nothing (all +inf) and four rows with every domain
    processed."""
    rs = np.random.RandomState(seed)
    entry = rs.choice(np.float32([0.5, 1.0, 2.0, np.inf]), size=(64, 16))
    entry[:4] = np.inf
    processed = rs.rand(64, 16) < 0.3
    processed[4:8] = True
    best_t = rs.choice(np.float32([0.75, 1.5, np.inf]), size=64)
    found = rs.rand(64) < 0.5
    return entry, processed, best_t, found


@pytest.mark.parametrize("occ_mode", [False, True], ids=["nearest", "anyhit"])
def test_needed_rule_matches_reference(occ_mode):
    """`needed`, the rule of both the out-of-core scheduler and the in-situ
    round, equals the reference's `needed_mask`."""
    entry, processed, best_t, found = _rule_inputs(1)
    n = entry.shape[0]
    state = JState(o=None, d=None, tmin=None, best_t=jnp.asarray(best_t),
                   best_prim=None, best_u=None, best_v=None,
                   found=jnp.asarray(found), entry_t=jnp.asarray(entry),
                   processed=jnp.asarray(processed),
                   occ_mode=jnp.asarray(occ_mode))
    want = np.asarray(j_needed_mask(state))
    got = needed(*map(torch.as_tensor, (entry, processed, best_t, found)),
                 occ_mode).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want[:8].any() and n > want.any(axis=1).sum()


def test_round_route_is_the_shared_nearest_rule():
    """The in-situ round's nearest domain is `nearest_needed`'s: on a mask
    with exact ties, all-infinite rows and rows that need nothing, it equals
    the route the round took before (where, argmin, gather, isfinite) and
    the reference's argmin, the lowest domain id of a tie."""
    entry, processed, best_t, found = _rule_inputs(2)
    entry_t = torch.as_tensor(entry)
    need = needed(entry_t, *map(torch.as_tensor, (processed, best_t, found)),
                  False)
    nearest, has, _ = nearest_needed(need, entry_t)
    masked = torch.where(need, entry_t, float("inf"))
    before = torch.argmin(masked, dim=1)
    has_before = torch.isfinite(torch.gather(masked, 1, before[:, None]))[:, 0]
    np.testing.assert_array_equal(nearest.numpy(), before.numpy())
    np.testing.assert_array_equal(has.numpy(), has_before.numpy())
    ref = np.asarray(jnp.argmin(jnp.where(need.numpy(), entry, jnp.inf),
                                axis=1))
    np.testing.assert_array_equal(nearest.numpy(), ref)
    m, tied = need.numpy(), 0
    for i in np.flatnonzero(m.any(axis=1)):
        ids = np.flatnonzero(m[i] & (entry[i] == entry[i][m[i]].min()))
        assert nearest[i] == ids[0]
        tied += len(ids) > 1
    assert tied > 5 and not has[:8].any() and has.any()


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_padded_pixel_ids_match_reference(n_shards):
    cam = make_camera(eye=(0, 0, 5), lookat=(0, 0, 0), up=(0, 1, 0),
                      fov_y_deg=40, width=13, height=7)
    ids_t, npix_t = trs.padded_pixel_ids(cam, n_shards)
    ids_j, npix_j = jrs.padded_pixel_ids(cam, n_shards)
    assert npix_t == npix_j and ids_t.dtype == ids_j.dtype
    np.testing.assert_array_equal(ids_t, ids_j)


@pytest.mark.parametrize("backend", ["cluster", "jnp"])
def test_insitu_setup_matches_reference(backend):
    """6 domains asked of 4 ranks: 8 domains, two per rank.  Each rank's
    resident slice, the owner map and the domain boxes equal the
    reference's (its sharded arrays read whole; w against its compact
    pages within the 2e-6 of tests/test_torch_build.py: the Woop transforms
    round differently)."""
    ref = jep._insitu_setup(SCENE, jrs.make_mesh(4), "dev", 6, leaf_size=8,
                            backend=backend)
    assert ref["n_domains"] == 8
    if backend == "cluster":
        host = j_pages(SCENE, 8)
        want = {k: np.asarray(ref["stacked"][k]) for k in ("bounds", "meta",
                                                           "tri_ids")}
        want["w"] = host["w"]
    else:
        want = {k: np.asarray(ref["stacked"][k]) for k in BVH_FIELDS}
    for rank in range(4):
        su = tep._insitu_setup(TSCENE, trs.Mesh(rank, 4, CPU), 6,
                               leaf_size=8, backend=backend)
        assert su["n_domains"] == 8 and su["ndev"] == 4
        assert set(su["local"]) == set(want)
        for k, v in want.items():
            got, v = su["local"][k].numpy(), v[2 * rank:2 * rank + 2]
            if k == "w":
                np.testing.assert_allclose(got, v, rtol=0, atol=2e-6)
            else:
                np.testing.assert_array_equal(got, v, err_msg=k)
        np.testing.assert_array_equal(su["owner"].numpy(),
                                      np.asarray(ref["owner"]))
        np.testing.assert_array_equal(su["aabb_lo"].numpy(),
                                      np.asarray(ref["aabb_lo"]))
        np.testing.assert_array_equal(su["aabb_hi"].numpy(),
                                      np.asarray(ref["aabb_hi"]))
        if backend == "cluster":
            assert su["depth"] == traverse.tree_depth(
                host["meta"][2 * rank:2 * rank + 2])
            for a, b in zip(su["tri_soa"], ref["tri_soa"]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
