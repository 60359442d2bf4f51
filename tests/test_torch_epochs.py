"""The port's out-of-core epoch scheduler and residency manager (plain
kernel versions on the CPU) == spray_tpu's cluster-backend OOCIntersector
(Pallas in interpret mode) and ResidencyManager, plus the port's own forms
of the reference's scheduler properties (tests/test_epochs.py); and the
port's jnp backend against the reference's (more in test_torch_ooc_jnp.py)."""

import itertools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.io.scenes import wisp_cloud
from spray_tpu.residency.manager import ResidencyManager as JResidency
from spray_tpu.sched.epochs import OOCIntersector as JOOC
from spray_tpu_torch.interop import scene_from_arrays
from spray_tpu_torch.oracle.brute import BruteIntersector
from spray_tpu_torch.residency.manager import ResidencyManager
from spray_tpu_torch.sched import epochs as port_epochs
from spray_tpu_torch.sched.epochs import (
    OOCIntersector, init_state, needed_mask, schedule_top_k,
)

SCENE = wisp_cloud(n_blobs=12, tris_per_blob=80, extent=4.0, seed=5)
TSCENE = scene_from_arrays(SCENE.vertices, SCENE.faces, SCENE.albedo,
                           SCENE.emission)
N = 512
STATS = ("epochs", "rays_traced", "rays_speculated", "committed",
         "domain_loads", "cache_hits", "prefetches")


def _rays(seed):
    v = np.asarray(SCENE.vertices)
    lo, hi = v.min(0), v.max(0)
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo - 1, hi + 1, (N, 3)).astype(np.float32)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o, d, np.zeros(N, np.float32), np.full(N, np.inf, np.float32),
            np.full(N, 1e30, np.float32))


def _t(x):
    return torch.as_tensor(x)


def _run_port(seed, **kw):
    o, d, tmin, tmax, far = _rays(seed)
    isect = OOCIntersector(TSCENE, n_domains=8, backend="cluster",
                           device="cpu", **kw)
    hits = isect.intersect(_t(o), _t(d), _t(tmin), _t(tmax))
    occ = isect.occluded(_t(o), _t(d), _t(far)).numpy()
    return isect, hits, occ


@pytest.fixture(scope="module", params=[(4, True), (4, False), (8, True)],
                ids=["device_batched", "host_driven", "all_resident"])
def ooc_pair(request):
    """(reference OOC, its hits and occlusion, port OOC, its hits and
    occlusion) on test_epochs.py's scene: 8 domains through 4 slots, batched
    and host-driven, and through 8 slots (all resident: one batch)."""
    num_slots, batched = request.param
    kw = dict(num_slots=num_slots, speculate=True, device_batched=batched)
    # Lookahead is on only where the constructor's timed 1 MB upload beats
    # 50 MB/s.  Pass both probes whatever the load of this machine: the
    # reference's clock ticks a nanosecond per reading during its
    # constructor, and the port's threshold is 0.
    ticks = itertools.count()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time", lambda: next(ticks) * 1e-9)
        jx = JOOC(SCENE, n_domains=8, backend="cluster", interpret=True, **kw)
    o, d, tmin, tmax, far = _rays(2)
    hj = jx.intersect(*map(jnp.asarray, (o, d, tmin, tmax)))
    occ_j = np.asarray(jx.occluded(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(far)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_epochs, "PROBE_MB_S", 0.0)
        px, ht, occ_t = _run_port(2, **kw)
    return jx, hj, occ_j, px, ht, occ_t


def test_ooc_hits_and_occlusion_match_reference(ooc_pair):
    _, hj, occ_j, _, ht, occ_t = ooc_pair
    vj = np.asarray(hj.valid)
    np.testing.assert_array_equal(ht.valid.numpy(), vj)
    tj, tt = np.asarray(hj.t)[vj], ht.t.numpy()[vj]
    np.testing.assert_allclose(tt, tj, rtol=2e-4)
    real = ((np.asarray(hj.prim)[vj] != ht.prim.numpy()[vj])
            & (np.abs(tt - tj) > 1e-4 * np.maximum(tj, 1)))
    assert real.mean() < 0.002
    np.testing.assert_array_equal(occ_t, occ_j)
    assert vj.sum() > 50 and occ_j.sum() > 50


def test_ooc_stats_match_reference(ooc_pair):
    jx, _, _, px, _, _ = ooc_pair
    assert jx.lookahead and px.lookahead  # both probes passed the gate
    for k in STATS:
        assert getattr(px.stats, k) == getattr(jx.stats, k), k
    assert px.stats.epochs > 1 and px.stats.domain_loads > 4
    assert [e["scheduled"] for e in px.epoch_log] == [
        e["scheduled"] for e in jx.epoch_log]


def test_ooc_matches_brute():
    _, hits, occ = _run_port(2, num_slots=4, speculate=True)
    o, d, tmin, tmax, far = map(_t, _rays(2))
    brute = BruteIntersector(TSCENE, device="cpu")
    hb = brute.intersect(o, d, tmin, tmax)
    np.testing.assert_array_equal(hits.valid.numpy(), hb.valid.numpy())
    m = hb.valid.numpy()
    np.testing.assert_allclose(hits.t.numpy()[m], hb.t.numpy()[m], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(occ, brute.occluded(o, d, far).numpy())


def test_commit_invariant_property():
    """For every ray after convergence: no unprocessed overlapped domain has
    entry_t < committed t (the reference's commit rule)."""
    o, d, tmin, tmax, _ = map(_t, _rays(13))
    isect = OOCIntersector(TSCENE, n_domains=8, num_slots=4, speculate=True,
                           backend="cluster", device="cpu")
    state = isect._run_epochs(init_state(isect.dset, o, d, tmin, tmax))
    assert not bool(needed_mask(state).any())
    viol = (~state.processed & torch.isfinite(state.entry_t)
            & (state.entry_t < state.best_t[:, None]))
    assert not bool(viol.any())
    assert isect.stats.epochs > 1


def test_device_batched_matches_host_driven():
    host, hh, occ_h = _run_port(9, num_slots=4, speculate=True,
                                device_batched=False)
    dev, hd, occ_d = _run_port(9, num_slots=4, speculate=True,
                               device_batched=True)
    np.testing.assert_array_equal(hh.valid.numpy(), hd.valid.numpy())
    np.testing.assert_array_equal(hh.prim.numpy(), hd.prim.numpy())
    np.testing.assert_array_equal(hh.t.numpy(), hd.t.numpy())
    np.testing.assert_array_equal(occ_h, occ_d)
    # one host round trip per residency change, not per epoch
    assert len(dev.epoch_log) <= len(host.epoch_log)
    assert dev.stats.epochs >= 1 and dev.stats.rays_traced > 0


def test_speculative_bounded_baseline_commit_the_same():
    """The commit set is policy-invariant: speculative, bounded (k=2) and
    strict baseline give identical prims, t and occlusion; only the work
    differs, with activations base <= k2 <= full and epochs full <= base."""
    res = {name: _run_port(11, num_slots=8, speculate=spec)
           for name, spec in (("base", False), ("k2", 2), ("full", True))}
    _, h0, occ0 = res["base"]
    for name in ("k2", "full"):
        _, h, occ = res[name]
        np.testing.assert_array_equal(h.valid.numpy(), h0.valid.numpy())
        np.testing.assert_array_equal(h.prim.numpy(), h0.prim.numpy())
        np.testing.assert_array_equal(h.t.numpy(), h0.t.numpy())
        np.testing.assert_array_equal(occ, occ0)
    act = {k: v[0].stats.rays_traced for k, v in res.items()}
    assert act["base"] <= act["k2"] <= act["full"]
    assert res["full"][0].stats.epochs <= res["base"][0].stats.epochs
    assert res["base"][0].stats.rays_speculated == 0
    assert res["full"][0].stats.rays_speculated > 0


def test_schedule_top_k_is_stable():
    counts = np.array([3, 0, 5, 3, 5, 1])
    assert schedule_top_k(counts, 3) == [2, 4, 0]
    assert schedule_top_k(counts, 10) == [2, 4, 0, 3, 5]


def test_jnp_backend_is_refused():
    """The jnp backend, which the port refused before it had bvh/, runs:
    `backend="jnp"` (and "auto" on the CPU) equals the reference's jnp
    backend on the same scene, 8 domains through 4 slots: hits, occlusion,
    scheduler counters and schedules."""
    o, d, tmin, tmax, far = _rays(2)
    ticks = itertools.count()
    with pytest.MonkeyPatch.context() as mp:  # lookahead on in both
        mp.setattr(time, "time", lambda: next(ticks) * 1e-9)
        jx = JOOC(SCENE, n_domains=8, num_slots=4, speculate=True)
    assert jx.backend == "jnp"
    hj = jx.intersect(*map(jnp.asarray, (o, d, tmin, tmax)))
    occ_j = np.asarray(jx.occluded(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(far)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_epochs, "PROBE_MB_S", 0.0)
        px = OOCIntersector(TSCENE, n_domains=8, num_slots=4, speculate=True,
                            device="cpu")
    assert px.backend == "jnp" and not px.device_batched
    ht = px.intersect(*map(_t, (o, d, tmin, tmax)))
    occ_t = px.occluded(_t(o), _t(d), _t(far)).numpy()
    vj = np.asarray(hj.valid)
    np.testing.assert_array_equal(ht.valid.numpy(), vj)
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    np.testing.assert_allclose(ht.t.numpy()[vj], np.asarray(hj.t)[vj], rtol=2e-4)
    np.testing.assert_array_equal(occ_t, occ_j)
    assert vj.sum() > 50 and occ_j.sum() > 50
    for k in STATS:
        assert getattr(px.stats, k) == getattr(jx.stats, k), k
    assert [e["scheduled"] for e in px.epoch_log] == [
        e["scheduled"] for e in jx.epoch_log]
    with pytest.raises(ValueError, match="backend"):
        OOCIntersector(TSCENE, n_domains=8, backend="pallas", device="cpu")


def test_residency_manager_matches_reference():
    """One acquire / prefetch / peek sequence through both managers: equal
    resident sets and counters after every step, and each handed-out page
    is the provider's."""
    rs = np.random.RandomState(0)
    pages = {d: {"w": rs.normal(size=(4, 6)).astype(np.float32),
                 "meta": np.full(3, d, np.int32)} for d in range(10)}

    def provider(d):
        return pages[d]

    jm = JResidency(None, 4, domain_provider=provider)
    tm = ResidencyManager(4, provider, "cpu")
    steps = [("acquire", [0, 1, 2]), ("acquire", [1, 3]),
             ("prefetch", [4, 5], [1, 3]), ("acquire", [4, 0]),
             ("peek", 3), ("acquire", [6, 7, 4]), ("prefetch", [8, 9], [6, 7, 4]),
             ("acquire", [9, 2]), ("acquire", [0, 1, 2, 9])]
    for step in steps:
        kind = step[0]
        if kind == "acquire":
            got = tm.acquire(step[1])
            jm.acquire(step[1])
            for d, page in zip(step[1], got):
                np.testing.assert_array_equal(page["w"].numpy(), pages[d]["w"])
                np.testing.assert_array_equal(page["meta"].numpy(),
                                              pages[d]["meta"])
        elif kind == "prefetch":
            assert tm.prefetch(step[1], pinned=step[2]) == jm.prefetch(
                step[1], pinned=step[2])
        else:
            np.testing.assert_array_equal(tm.peek(step[1])["w"].numpy(),
                                          pages[step[1]]["w"])
            jm.peek(step[1])
        assert tm.resident_ids == jm.resident_ids, step
        assert tm._lru == jm._lru, step
        assert (tm.loads, tm.hits, tm.prefetches) == (
            jm.loads, jm.hits, jm.prefetches), step
    with pytest.raises(ValueError):
        tm.acquire([0, 1, 2, 3, 4])
