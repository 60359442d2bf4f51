"""The deployment of the benchmark's cell `wisp2m-ooc8s8.frame-spp1` cut to
a scene and frame the CPU renders in a second: `OOCIntersector` on the
cluster backend with as many slots as domains (8), so that every domain is
resident and each trace call is one speculative batch over all of them.

- a frame through `render_device` agrees with the plain reference
  (`benchmark/reference`) at the same seed;
- the speculative and the non-speculative all-resident intersectors commit
  the same hits and occlusion (SpRay's own check);
- under torch.profiler each `intersect` and `occluded` call opens one
  `spray.sched.batch`, and every `spray.sync.more` and `spray.sync.traced`
  lies inside a `spray.sched.*` span, where the benchmark's
  `sched_syncs` reader counts it;
- a frame opens no `spray.residency.*` span and loads no domain: the 8
  pages are acquired once, by the constructor."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import check, harness
from benchmark.metrics import _spans
from benchmark.profile import from_profiler
from benchmark.reference.render import Reference, make_camera
from benchmark.scenes import make_scene
from benchmark.tests._tiny import TINY_CAMERA, TINY_SCENE
from spray_tpu_torch.core.config import RenderConfig
from spray_tpu_torch.core.types import Camera, Scene
from spray_tpu_torch.integrators.device import render_device
from spray_tpu_torch.sched import epochs as port_epochs
from spray_tpu_torch.sched.epochs import OOCIntersector

CPU = "cpu"
SIZE = 24
DOMAINS = 8
# the cell's frame: spp 1, bounces 2, PT+NEE; seeds of the cell's pool and
# one above 32 signed bits
SEEDS = (657226250, 2**31 + 77)
CALLS = 5  # trace calls a frame: intersect at each of 3 depths, 2 occluded
# the share of lit pixels off the reference, as in the other frame cells'
# tests: the port tests triangles with Woop's transform and the reference
# with Möller–Trumbore, so a ray grazing an edge or a tie between two
# triangles can take the other triangle on one side (PERF.md §4)
MISMATCH = 0.03


def _cfg(seed):
    return RenderConfig(width=SIZE, height=SIZE, spp=1, bounces=2,
                        integrator="pt", nee=True, seed=seed)


@pytest.fixture(scope="module")
def arrays():
    return make_scene(TINY_SCENE)


@pytest.fixture(scope="module")
def camera():
    return make_camera(**TINY_CAMERA, width=SIZE, height=SIZE)


def _intersector(arrays, speculate=True):
    """All 8 domains in 8 slots, the cell's options; lookahead on whatever
    this machine's upload rate (its 2 reserve slots stay unused)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_epochs, "PROBE_MB_S", 0.0)
        isect = OOCIntersector(Scene(**arrays), n_domains=DOMAINS,
                               num_slots=DOMAINS, speculate=speculate,
                               lookahead=True, backend="cluster",
                               max_epochs=256, device=CPU)
    assert isect.all_resident and isect.dset.num_domains == DOMAINS
    return isect


@pytest.fixture(scope="module")
def traced(arrays, camera):
    """One untraced frame, then two frames under torch.profiler: the
    intersector, the domain loads after its constructor, the trace calls
    of the traced frames, the Trace and the loads after them."""
    isect = _intersector(arrays)
    loads_built = isect.residency.loads
    cam = Camera(**camera)
    render_device(Scene(**arrays), cam, _cfg(SEEDS[0]), intersector=isect,
                  device=CPU)
    calls = []
    for name in ("intersect", "occluded"):
        fn = getattr(isect, name)

        def counted(*a, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*a)
        setattr(isect, name, counted)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for seed in SEEDS:
            render_device(Scene(**arrays), cam, _cfg(seed),
                          intersector=isect, device=CPU)
    return {"isect": isect, "loads_built": loads_built, "calls": calls,
            "trace": from_profiler(prof)}


def _program(tr, prefix):
    return [iv for iv in tr.host if iv.name.startswith(prefix)]


def _inside(iv, outer):
    return any(o.start_us <= iv.start_us and iv.end_us <= o.end_us
               for o in outer)


@pytest.mark.parametrize("seed", SEEDS)
def test_frame_matches_the_plain_reference(arrays, camera, seed):
    isect = _intersector(arrays)
    img = render_device(Scene(**arrays), Camera(**camera), _cfg(seed),
                        intersector=isect, device=CPU)
    img = np.asarray(img)
    assert img.shape == (SIZE, SIZE, 3)
    assert np.isfinite(img).all() and (img > 0).any()
    ids = np.arange(SIZE * SIZE)
    cfg = check.reference_cfg({"spp": 1, "bounces": 2, "nee": True}, seed)
    px = Reference(arrays, CPU).pixels(camera, cfg, torch.as_tensor(ids))
    assert check.pixel_mismatch(img, px, ids) < MISMATCH


def _rays(arrays, n=512, seed=7):
    v = np.asarray(arrays["vertices"])
    lo, hi = v.min(0), v.max(0)
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo - 1, hi + 1, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o), torch.as_tensor(d), torch.zeros(n),
            torch.full((n,), np.inf), torch.full((n,), 1e30))


def test_speculative_and_front_to_back_commit_the_same_hits(arrays):
    o, d, tmin, tmax, far = _rays(arrays)
    out = {}
    for spec in (True, False):
        isect = _intersector(arrays, speculate=spec)
        out[spec] = (isect.intersect(o, d, tmin, tmax),
                     isect.occluded(o, d, far).numpy(), isect.stats)
    (hs, occ_s, st_s), (hb, occ_b, st_b) = out[True], out[False]
    valid = hb.valid.numpy()
    np.testing.assert_array_equal(hs.valid.numpy(), valid)
    ts, tb = hs.t.numpy()[valid], hb.t.numpy()[valid]
    np.testing.assert_allclose(ts, tb, rtol=2e-4)
    real = ((hs.prim.numpy()[valid] != hb.prim.numpy()[valid])
            & (np.abs(ts - tb) > 1e-4 * np.maximum(tb, 1)))
    assert real.mean() < 0.002
    np.testing.assert_array_equal(occ_s, occ_b)
    assert valid.sum() > 50 and occ_b.sum() > 50
    # speculation traces more ray-domain pairs, front to back none beyond
    # each ray's nearest needed domain
    assert st_s.rays_traced > st_b.rays_traced
    assert st_b.rays_speculated == 0 < st_s.rays_speculated


def test_each_call_is_one_batch_and_its_reads_lie_in_scheduler_spans(traced):
    tr, calls = traced["trace"], traced["calls"]
    assert len(calls) == CALLS * len(SEEDS)
    assert calls.count("occluded") == 2 * len(SEEDS)
    batches = _program(tr, "spray.sched.batch")
    assert len(batches) == len(calls)
    for name in ("spray.sched.epochs", "spray.sched.absorb"):
        inner = _program(tr, name)
        assert len(inner) == len(calls), name
        assert all(_inside(iv, batches) for iv in inner), name
    assert not _program(tr, "spray.sched.counts")
    sched = _program(tr, "spray.sched.")
    reads = [iv for iv in _program(tr, "spray.sync.")
             if iv.name in ("spray.sync.more", "spray.sync.traced")]
    assert sum(iv.name == "spray.sync.traced" for iv in reads) == len(calls)
    assert all(_inside(iv, sched) for iv in reads)
    # the benchmark's readers count them as the scheduler's, and only the
    # committed counts and the image as the glue's
    rec = harness.Record(setup_s=0.0, build_s=0.0, trace=tr,
                         traced_steps=len(SEEDS))
    outside = [iv.name for iv in _program(tr, "spray.sync.")
               if not _inside(iv, sched)]
    assert set(outside) == {"spray.sync.committed", "spray.sync.image"}
    assert _spans.syncs_per_step(rec, in_sched=True) == len(reads) / len(SEEDS)
    assert _spans.syncs_per_step(rec, in_sched=False) == (
        len(outside) / len(SEEDS))


def test_frames_load_no_domain(traced):
    assert not _program(traced["trace"], "spray.residency.")
    assert traced["loads_built"] == DOMAINS
    stats = traced["isect"].stats
    assert stats.domain_loads == DOMAINS and stats.prefetches == 0
