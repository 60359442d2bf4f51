"""The port's jnp out-of-core backend (OOCIntersector(backend="jnp"): the
epoch scheduler over per-domain BVHs) and its MultiDomainIntersector
against spray_tpu's on the same domain set and rays, the brute oracle and
the commit invariant: the counterparts of tests/test_epochs.py's jnp cases
and of tests/test_multidomain.py's equivalence, on the CPU."""

import dataclasses
import itertools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.domains.partition import partition_scene as j_partition_scene
from spray_tpu.io.scenes import wisp_cloud
from spray_tpu.sched.epochs import OOCIntersector as JOOC
from spray_tpu.sched.multidomain import MultiDomainIntersector as JMulti
from spray_tpu_torch.bvh.traverse import BVHIntersector
from spray_tpu_torch.domains.partition import DomainSet, partition_scene
from spray_tpu_torch.interop import domain_set_from_numpy, scene_from_arrays
from spray_tpu_torch.oracle.brute import BruteIntersector
from spray_tpu_torch.sched import epochs as port_epochs
from spray_tpu_torch.sched.epochs import OOCIntersector, init_state, needed_mask
from spray_tpu_torch.sched.multidomain import MultiDomainIntersector

SCENE = wisp_cloud(n_blobs=12, tris_per_blob=80, extent=4.0, seed=5)
TSCENE = scene_from_arrays(SCENE.vertices, SCENE.faces, SCENE.albedo,
                           SCENE.emission)
JDSET = j_partition_scene(SCENE, 16, leaf_size=8)
N = 512
STATS = ("epochs", "rays_traced", "rays_speculated", "committed",
         "domain_loads", "cache_hits", "prefetches")


def _rays(n, seed):
    v = np.asarray(SCENE.vertices)
    rs = np.random.RandomState(seed)
    o = rs.uniform(v.min(0) - 1, v.max(0) + 1, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, np.zeros(n, np.float32), np.full(n, np.inf, np.float32)


def _port(dset, **kw):
    """The port's jnp-backend OOCIntersector, lookahead on whatever the load
    of this machine (the threshold 0)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_epochs, "PROBE_MB_S", 0.0)
        return OOCIntersector(dset=dset, device="cpu", **kw)


@pytest.fixture(scope="module")
def ref():
    """The reference's jnp OOCIntersector, speculative and strict, on JDSET:
    hits, occlusion and counters.  Its lookahead probe passes whatever the
    load (its clock ticks a nanosecond per reading in the constructor)."""
    o, d, tmin, tmax = map(jnp.asarray, _rays(N, 2))
    out = {}
    for name, spec in (("spec", True), ("base", False)):
        ticks = itertools.count()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(time, "time", lambda: next(ticks) * 1e-9)
            jx = JOOC(dset=JDSET, num_slots=4, speculate=spec)
        assert jx.backend == "jnp" and jx.lookahead
        h = jx.intersect(o, d, tmin, tmax)
        out[name] = ({k: np.asarray(getattr(h, k))
                      for k in ("t", "prim", "u", "v", "valid")},
                     {k: getattr(jx.stats, k) for k in STATS},
                     [e["scheduled"] for e in jx.epoch_log])
    o9, d9, _, _ = map(jnp.asarray, _rays(256, 9))
    out["occ"] = np.asarray(jx.occluded(o9, d9, jnp.full(256, 1e30)))
    return out


def test_partition_matches_reference():
    """partition_scene's DomainSet (per-domain BVHs, padded and stacked)
    equals the reference's bit for bit, and so does the converter's."""
    ours = partition_scene(TSCENE, 16, leaf_size=8)
    for got in (ours, domain_set_from_numpy(JDSET)):
        for f in dataclasses.fields(DomainSet):
            a, b = getattr(JDSET, f.name), getattr(got, f.name)
            if f.name == "leaf_size":
                assert a == b
            else:
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
    assert ours.num_domains == 16 and ours.bytes_per_domain == JDSET.bytes_per_domain


def test_ooc_matches_brute_and_speculation_equivalence(ref):
    """Speculative and strict baseline against the brute oracle, equal to
    each other bit for bit, and equal to the reference's on the same domain
    set: hits, counters (epochs included) and schedules."""
    o, d, tmin, tmax = map(torch.as_tensor, _rays(N, 2))
    hr = BruteIntersector(TSCENE, device="cpu").intersect(o, d, tmin, tmax)
    dset = domain_set_from_numpy(JDSET)
    spec = _port(dset, num_slots=4, speculate=True)
    base = _port(dset, num_slots=4, speculate=False)
    hs, hb = spec.intersect(o, d, tmin, tmax), base.intersect(o, d, tmin, tmax)
    m = hr.valid.numpy()
    for h in (hs, hb):
        np.testing.assert_array_equal(h.valid.numpy(), m)
        np.testing.assert_allclose(h.t.numpy()[m], hr.t.numpy()[m], rtol=1e-5,
                                   atol=1e-6)
        assert (h.prim.numpy()[m] == hr.prim.numpy()[m]).mean() > 0.998
    for k in ("t", "prim", "u", "v", "valid"):  # the same committed hits
        assert torch.equal(getattr(hs, k), getattr(hb, k)), k
    for name, isect, h in (("spec", spec, hs), ("base", base, hb)):
        hj, stats, sched = ref[name]
        np.testing.assert_array_equal(h.valid.numpy(), hj["valid"])
        np.testing.assert_array_equal(h.prim.numpy(), hj["prim"])
        np.testing.assert_allclose(h.t.numpy()[m], hj["t"][m], rtol=2e-4)
        assert {k: getattr(isect.stats, k) for k in STATS} == stats, name
        assert [e["scheduled"] for e in isect.epoch_log] == sched, name
    assert spec.stats.epochs <= base.stats.epochs
    assert spec.stats.rays_speculated > 0 and base.stats.rays_speculated == 0
    assert spec.stats.domain_loads >= 4


def test_ooc_occlusion_matches_brute(ref):
    o, d, _, _ = map(torch.as_tensor, _rays(256, 9))
    far = torch.full((256,), 1e30)
    occ = _port(domain_set_from_numpy(JDSET), num_slots=4,
                speculate=True).occluded(o, d, far).numpy()
    np.testing.assert_array_equal(
        occ, BruteIntersector(TSCENE, device="cpu").occluded(o, d, far).numpy())
    np.testing.assert_array_equal(occ, ref["occ"])
    assert occ.any() and not occ.all()


def test_commit_invariant_property():
    """After convergence no unprocessed overlapped domain has entry_t <
    committed t (the reference's commit rule)."""
    o, d, tmin, tmax = map(torch.as_tensor, _rays(N, 13))
    isect = _port(domain_set_from_numpy(JDSET), num_slots=4, speculate=True)
    state = isect._run_epochs(init_state(isect.dset, o, d, tmin, tmax))
    assert not bool(needed_mask(state).any())
    viol = (~state.processed & torch.isfinite(state.entry_t)
            & (state.entry_t < state.best_t[:, None]))
    assert not bool(viol.any())
    assert isect.stats.epochs > 1


def test_multidomain_intersector_matches_reference_and_bvh():
    """MultiDomainIntersector (every domain resident, a loop over them) ==
    the reference's lax.scan over the same domain set, and == one BVH over
    the merged scene on valid, t and occlusion."""
    rays = _rays(N, 4)
    o, d, tmin, tmax = map(torch.as_tensor, rays)
    jx = JMulti(dset=JDSET)
    hj = jx.intersect(*map(jnp.asarray, rays))
    tx = MultiDomainIntersector(dset=domain_set_from_numpy(JDSET), device="cpu")
    ht = tx.intersect(o, d, tmin, tmax)
    vj = np.asarray(hj.valid)
    np.testing.assert_array_equal(ht.valid.numpy(), vj)
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    np.testing.assert_allclose(ht.t.numpy()[vj], np.asarray(hj.t)[vj], rtol=2e-4)
    far = torch.full((N,), 1e30)
    occ = tx.occluded(o, d, far).numpy()
    np.testing.assert_array_equal(
        occ, np.asarray(jx.occluded(jnp.asarray(rays[0]), jnp.asarray(rays[1]),
                                    jnp.full(N, 1e30))))
    one = BVHIntersector(TSCENE, leaf_size=8, device="cpu")
    h1 = one.intersect(o, d, tmin, tmax)
    np.testing.assert_array_equal(h1.valid.numpy(), vj)
    np.testing.assert_allclose(h1.t.numpy()[vj], ht.t.numpy()[vj], rtol=1e-6)
    np.testing.assert_array_equal(one.occluded(o, d, far).numpy(), occ)
    assert vj.sum() > 50
