"""spray_tpu_torch.trace: the program's spans and counters.

Off (no profiler recording) a span is a shared no-op and the profiler's API
is never called; on, under `torch.profiler`, the spans of a pipeline frame,
a training step and an out-of-core frame reach `benchmark.profile.
from_profiler(prof).host` (not dropped as user annotations), nested in the
step's span, the `live_rays` counter equals `Pipeline.rays_traced`, and
images, losses and gradients are bit-equal with tracing on and off.  Also
the benchmark's readers of the spans and counters (`benchmark/metrics/
_spans.py`) on synthetic traces."""

import itertools

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.metrics import _spans
from benchmark.profile import Interval, Trace, from_profiler
from spray_tpu_torch import trace
from spray_tpu_torch.core.camera import make_camera
from spray_tpu_torch.core.config import RenderConfig
from spray_tpu_torch.integrators.device import render_device
from spray_tpu_torch.io.scenes import wisp_cloud
from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector
from spray_tpu_torch.render import make_pipeline
from spray_tpu_torch.sched import epochs as port_epochs
from spray_tpu_torch.sched.epochs import OOCIntersector

SCENE = wisp_cloud(n_blobs=8, tris_per_blob=80, extent=4.0, seed=5)
CAM = make_camera(eye=(7.0, 5.0, 9.0), lookat=(0.0, 0.0, 0.0), up=(0, 1, 0),
                  fov_y_deg=45, width=12, height=12)
CFG = RenderConfig(width=12, height=12, spp=2, bounces=2, seed=11)
KINDS = ("frame", "train", "ooc")

GLUE = {"spray.glue.camera", "spray.glue.rng", "spray.glue.bounce",
        "spray.glue.intersect", "spray.glue.shade", "spray.glue.nee",
        "spray.glue.light", "spray.glue.scatter", "spray.glue.partition",
        "spray.glue.hits"}
ROUTED = {"spray.glue.route", "spray.glue.order", "spray.glue.launch",
          "spray.glue.accumulate"}
EXPECTED = {
    "frame": {"spray.step"} | ROUTED | GLUE,
    "train": {"spray.step", "spray.autograd.forward",
              "spray.autograd.backward", "spray.glue.scene_arrays"}
    | ROUTED | GLUE,
    "ooc": {"spray.frame", "spray.glue.scene_arrays", "spray.sched.batch",
            "spray.sched.counts", "spray.sched.epochs", "spray.sched.slot",
            "spray.sched.lookahead", "spray.sched.absorb",
            "spray.residency.acquire", "spray.residency.prefetch",
            "spray.residency.upload",
            "spray.sync.counts", "spray.sync.more", "spray.sync.traced",
            "spray.sync.committed", "spray.sync.image"} | GLUE,
}
# (span, the span it must lie in directly or further out)
INSIDE = [("spray.glue.intersect", "spray.glue.bounce"),
          ("spray.glue.nee", "spray.glue.bounce"),
          ("spray.glue.scatter", "spray.glue.bounce"),
          ("spray.glue.route", "spray.glue.bounce"),
          ("spray.glue.order", "spray.glue.route"),
          ("spray.glue.partition", "spray.glue.route"),
          ("spray.glue.launch", "spray.glue.bounce"),
          ("spray.glue.hits", "spray.glue.bounce"),
          ("spray.glue.shade", "spray.glue.bounce"),
          ("spray.glue.light", "spray.glue.nee"),
          ("spray.glue.bounce", "spray.autograd.forward"),
          ("spray.glue.accumulate", "spray.autograd.forward"),
          ("spray.sched.batch", "spray.glue.bounce"),
          ("spray.sched.counts", "spray.sched.batch"),
          ("spray.sched.epochs", "spray.sched.batch"),
          ("spray.sched.slot", "spray.sched.epochs"),
          ("spray.sched.lookahead", "spray.sched.batch"),
          ("spray.sync.counts", "spray.sched.counts"),
          ("spray.sync.more", "spray.sched.epochs"),
          ("spray.residency.acquire", "spray.sched.batch"),
          ("spray.residency.prefetch", "spray.sched.lookahead"),
          ("spray.residency.upload", "spray.sched.batch"),
          ("spray.sched.absorb", "spray.sched.batch")]


def _step(kind):
    """A fresh step fn of `kind` and the count of rays it traced (None
    where the entry gives none)."""
    if kind == "ooc":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_epochs, "PROBE_MB_S", 0.0)  # lookahead on
            isect = OOCIntersector(SCENE, n_domains=8, num_slots=2,
                                   backend="cluster", device="cpu")
        assert isect.lookahead and isect.reserve == 1

        def frame():
            return render_device(SCENE, CAM, CFG, intersector=isect,
                                 device="cpu")
        frame.intersector = isect
        return frame, None
    isect = MultiDomainClusterIntersector(SCENE, n_domains=4, device="cpu")
    pipe = make_pipeline(SCENE, CAM, CFG, backward=kind == "train",
                         intersector=isect, device="cpu")
    return pipe.run, pipe.rays_traced


def _profiled(fn, steps):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = [fn() for _ in range(steps)]
    return outs, from_profiler(prof), trace.read()


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return bool((a == b).all()) if hasattr(a, "all") else a == b


@pytest.fixture(scope="module", params=KINDS)
def runs(request):
    """(kind, outputs of 2 steps off, outputs of the next 2 steps profiled,
    the profiled trace, the trace's counters, rays_traced)."""
    fn, rays = _step(request.param)
    fn()  # warm-up, untraced
    off = [fn(), fn()]
    fn2, _ = _step(request.param)
    fn2()
    on, tr, counters = _profiled(fn2, 2)
    return request.param, off, on, tr, counters, rays


def _program(tr):
    return [iv for iv in tr.host if iv.name.startswith("spray.")]


def test_spans_reach_the_trace_nested_in_the_step(runs):
    kind, _, _, tr, _, _ = runs
    spans = _program(tr)
    assert {iv.name for iv in spans} == EXPECTED[kind]
    tops = [iv for iv in spans if iv.name in ("spray.step", "spray.frame")]
    assert len(tops) == 2  # one a step, each a host op (no user annotation)
    for iv in spans:
        assert any(t.start_us <= iv.start_us and iv.end_us <= t.end_us
                   for t in tops), iv
    for a, b in itertools.combinations(spans, 2):  # nested or disjoint
        inner = (a.start_us >= b.start_us and a.end_us <= b.end_us) or (
            b.start_us >= a.start_us and b.end_us <= a.end_us)
        assert inner or a.end_us <= b.start_us or b.end_us <= a.start_us
    for child, parent in INSIDE:
        outer = [iv for iv in spans if iv.name == parent]
        for iv in spans:
            if iv.name == child and outer:
                assert any(p.start_us <= iv.start_us and iv.end_us <= p.end_us
                           for p in outer), (child, parent)


def test_live_rays_counts_the_rays_traced(runs):
    kind, _, on, tr, counters, rays = runs
    assert counters["live_rays"] > 0
    if rays is not None:
        assert counters["live_rays"] == sum(rays(out) for out in on)
    if kind == "ooc":  # each sync site at least once a frame
        assert sum(iv.name.startswith("spray.sync.")
                   for iv in _program(tr)) >= 5 * 2
    assert "node_visits" not in counters  # the plain versions count nothing
    # the scene-only inputs were built before the window: reused in it
    assert counters.get("scene_builds") == (None if kind == "frame" else 0)


def test_outputs_bit_equal_with_tracing_on_and_off(runs):
    _, off, on, _, _, _ = runs
    assert _same(off, on)


def test_off_records_nothing_and_never_calls_the_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the profiler's API was called")

    before = trace.read()
    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    for kind in KINDS:
        fn, _ = _step(kind)
        fn()
    assert trace.span("spray.step") is trace.sync("step") is trace._OFF
    assert trace.kernel_counters(torch.device("cpu")) is None
    trace.count("live_rays", 7)
    assert trace.read() == before


def test_counters_start_anew_in_each_window():
    dev = torch.device("cpu")
    for n in (1, 2):
        with profile(activities=[ProfilerActivity.CPU]):
            buf = trace.kernel_counters(dev)
            assert buf is trace.kernel_counters(dev) and buf.tolist() == [0] * 3
            buf += torch.tensor([3, 2, 1]) * n
            trace.count("live_rays", torch.tensor(5))
            trace.count("live_rays", 4)
            with trace.sync("step"):
                pass
        assert trace.read() == {"live_rays": 9, "node_visits": 3 * n,
                                "leaf_visits": 2 * n, "tri_tests": n}


def test_epoch_log_keeps_the_newest_batches(monkeypatch):
    monkeypatch.setattr(port_epochs, "EPOCH_LOG_ROWS", 3)
    frame, _ = _step("ooc")
    isect = frame.intersector
    frame()
    frame()
    log = list(isect.epoch_log)
    assert len(log) == 3 and log[-1]["epoch"] == isect.stats.epochs > 3


def _read(name, rec):
    return harness._load_module(harness.reader_path(name),
                                "m_" + name.replace(".", "_")).read(rec)


def _record(tr, steps=2):
    rec = harness.Record(setup_s=1.0, build_s=1.0)
    rec.trace, rec.traced_steps, rec.traced_wall_s = tr, steps, 1e-3
    return rec


SYNTH = Trace(
    device=[Interval("k1", 0, 10), Interval("k2", 20, 30),
            Interval("k3", 40, 50), Interval("k4", 100, 110),
            Interval("k5", 130, 140), Interval("k6", 200, 210)],
    host=[Interval("spray.step", 0, 112),
          Interval("spray.glue.bounce", 5, 60),
          Interval("aten::add", 12, 18),
          Interval("spray.sync.step", 33, 38),
          Interval("spray.autograd.backward", 115, 150),
          Interval("autograd::engine::evaluate_function: X", 140, 190)])


def test_idle_goes_to_the_innermost_program_span():
    got = _spans.idle_us_by_span(SYNTH)
    # aten::add runs at 15, inside the glue span inside spray.step: the glue
    # span wins; 75 lies under spray.step alone, 170 under an aten op only
    assert got == {"spray.glue.bounce": 10, "spray.sync.step": 10,
                   "spray.step": 50, "spray.autograd.backward": 20,
                   None: 60}
    rec = _record(SYNTH)
    assert _read("glue_idle_ms.step", rec) == pytest.approx(0.005)
    assert _read("backward_idle_ms.step", rec) == pytest.approx(0.01)
    assert _read("sched_idle_ms.frame", rec) == 0.0
    assert _read("residency_idle_ms.frame", rec) == 0.0
    assert _read("syncs.offline", rec) == 0.5
    assert _read("sched_syncs.frame", rec) == 0.0


def test_syncs_are_filed_under_the_scheduler_or_the_glue():
    tr = Trace(device=SYNTH.device,
               host=[Interval("spray.frame", 0, 300),
                     Interval("spray.sched.batch", 10, 100),
                     Interval("spray.sched.counts", 12, 30),
                     Interval("spray.sync.counts", 14, 20),
                     Interval("spray.sync.traced", 80, 90),
                     Interval("spray.sched.batch", 120, 200),
                     Interval("spray.sync.more", 150, 160),
                     Interval("spray.sync.committed", 205, 210),
                     Interval("spray.sync.image", 280, 290)])
    rec = _record(tr)
    assert _read("sched_syncs.frame", rec) == 1.5
    assert _read("syncs.frame", rec) == 1.0


def test_span_and_counter_readers_with_nothing_to_read(monkeypatch):
    bare = Trace(device=SYNTH.device,
                 host=[iv for iv in SYNTH.host
                       if not iv.name.startswith("spray.")])
    for name in ("glue_idle_ms.frame", "sched_idle_ms.frame",
                 "residency_idle_ms.frame", "backward_idle_ms.step",
                 "syncs.step", "sched_syncs.frame"):
        assert _read(name, _record(bare)) is None, name
    monkeypatch.setattr(trace, "read", lambda: {"live_rays": 10})
    assert _read("live_rays.frame", _record(bare)) == 5
    for name in ("node_visits.step", "tri_tests.offline"):
        assert _read(name, _record(bare)) is None, name


def test_scene_builds_reads_the_counter_per_step(monkeypatch):
    rec = _record(SYNTH, steps=3)
    monkeypatch.setattr(trace, "read", lambda: {"scene_builds": 0,
                                                "live_rays": 9})
    assert _read("scene_builds.step", rec) == 0.0
    monkeypatch.setattr(trace, "read", lambda: {"scene_builds": 6})
    assert _read("scene_builds.frame", rec) == 2.0
    monkeypatch.setattr(trace, "read", lambda: {"live_rays": 9})
    assert _read("scene_builds.step", rec) is None
    assert _read("scene_builds.frame", rec) is None
