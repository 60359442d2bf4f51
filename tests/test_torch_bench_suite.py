"""bench_torch.py --suite, the port's counterpart of bench.py's scheduler
suite (spec_suite), against the reference on the same tiny inputs.

Each of the five variants runs through `bench_torch.suite_row` and through
the reference's OOCIntersector the way bench.py's spec_suite runs it (one
warm-up render, the counters and residency counters reset, three renders,
the sums // 3), on the same scene, camera and config; on the CPU "auto" is
the jnp backend in both packages.  Both schedulers decide their prefetch
lookahead by timing one upload: it is held open in both (the port's
threshold 0, the reference's clock a nanosecond a reading), as in
tests/test_torch_io_cli.py.  The jnp backend has no bound on speculation
(in both packages only the cluster backend's device-batched epochs apply
`speculate=3`), so there config3_bounded3's counters equal
config3_speculative's; the config-3 variants are therefore also held
against the reference's cluster backend (its Pallas kernels in interpret
mode, the port's plain versions), where the bound binds at this size:
fewer activations and more epochs than unbounded speculation.

The whole entry runs as its own process with bench_torch.main, the curve
cut to one rank on a small scene and the JSON written to a temporary file.
"""

import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_torch
from spray_tpu.core.camera import make_camera as j_camera
from spray_tpu.core.config import RenderConfig as JConfig
from spray_tpu.integrators.device import render_device as j_render_device
from spray_tpu.io.scenes import wisp_cloud as j_wisp
from spray_tpu.sched.epochs import OOCIntersector as JOOC
from spray_tpu_torch.core.camera import make_camera
from spray_tpu_torch.core.config import RenderConfig
from spray_tpu_torch.io.scenes import wisp_cloud
from spray_tpu_torch.sched import epochs as port_epochs

ROOT = Path(__file__).resolve().parents[1]
SCENE = dict(n_blobs=8, tris_per_blob=80, seed=3)  # 642 tris
CAM = dict(eye=(14.0, 10.0, 18.0), lookat=(0, 0, 0), up=(0, 1, 0),
           fov_y_deg=45, width=16, height=16)
CFG = dict(spp=1, bounces=2, integrator="pt", seed=0)
COUNTERS = ("epochs", "rays_traced", "rays_speculated", "committed",
            "domain_loads", "cache_hits", "prefetches")
VARIANTS = {v[0]: v for v in bench_torch.SUITE_VARIANTS}


CLUSTER = [k for k in VARIANTS if k.startswith("config3")]


def reference_rows(names, **extra):
    """Per variant of `names`: the reference's counters per frame, its
    efficiency over the timed renders, its lookahead and backend, with the
    OOCIntersector options `extra` added to the variant's."""
    scene, cam, cfg = j_wisp(**SCENE), j_camera(**CAM), JConfig(**CFG)
    timed = bench_torch.SUITE_TIMED
    out = {}
    for name in names:
        _, n_domains, num_slots, kw = VARIANTS[name]
        ticks = itertools.count()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(time, "time", lambda: next(ticks) * 1e-9)
            oc = JOOC(scene, n_domains=n_domains, num_slots=num_slots, **kw,
                      **extra)
        j_render_device(scene, cam, cfg, intersector=oc)
        oc.stats = type(oc.stats)()
        oc.residency.hits = oc.residency.loads = oc.residency.prefetches = 0
        for _ in range(timed):
            j_render_device(scene, cam, cfg, intersector=oc)
        s = oc.stats
        out[name] = {k: getattr(s, k) // timed for k in COUNTERS}
        out[name].update(speculation_efficiency=s.speculation_efficiency,
                         lookahead_active=bool(oc.lookahead), backend=oc.backend)
    return out


@pytest.fixture(scope="module")
def reference():
    """Every variant on the reference's "auto" backend (jnp on the CPU)."""
    return reference_rows(VARIANTS)


@pytest.fixture(scope="module")
def reference_cluster():
    """The config-3 variants on the reference's cluster backend."""
    return reference_rows(CLUSTER, backend="cluster")


def port_row(name, **extra):
    _, n_domains, num_slots, kw = VARIANTS[name]
    return bench_torch.suite_row(
        wisp_cloud(**SCENE), make_camera(**CAM), RenderConfig(**CFG), n_domains,
        num_slots, torch.device("cpu"), **kw, **extra)


def assert_counters_equal(row, oc, ref, backend):
    assert oc.backend == ref["backend"] == backend
    for k in COUNTERS:
        assert row[k] == ref[k], (k, row[k], ref[k])
    assert row["speculation_efficiency"] == ref["speculation_efficiency"]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_suite_row_counters_match_reference(reference, name, monkeypatch):
    """epochs, activations, speculated, committed, efficiency, loads, hits
    and prefetches of the variant == the reference's."""
    kw = VARIANTS[name][3]
    monkeypatch.setattr(port_epochs, "PROBE_MB_S", 0.0)
    row, img, oc = port_row(name)
    assert_counters_equal(row, oc, reference[name], "jnp")
    assert row["lookahead_active"] == reference[name]["lookahead_active"] \
        == kw["lookahead"]
    assert row["epochs"] > 0 and row["committed"] > 0
    if name == "config3_baseline":
        assert row["rays_speculated"] == 0
    if name == "config4_prefetch":
        assert row["prefetches"] > 0 and row["host_to_hbm_mbps"] > 0
    assert len(row["frame_times_s"]) == bench_torch.SUITE_TIMED
    assert row["frame_s"] == min(row["frame_times_s"]) > 0
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0


@pytest.mark.parametrize("name", CLUSTER)
def test_suite_row_cluster_counters_match_reference(reference_cluster, name):
    """The config-3 variants on the cluster backend (where speculate=3
    applies): the counters == the reference's cluster backend's."""
    row, img, oc = port_row(name, backend="cluster")
    assert_counters_equal(row, oc, reference_cluster[name], "cluster")
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0


def test_cluster_speculation_bound_binds(reference_cluster):
    """On the reference's cluster backend the bound of 3 domains an epoch
    changes the schedule at this size: fewer activations and speculated
    rays, more epochs than unbounded speculation, and more activations and
    fewer epochs than none; the committed rays do not change."""
    spec, bounded, base = (reference_cluster[k] for k in CLUSTER)
    assert base["rays_traced"] < bounded["rays_traced"] < spec["rays_traced"]
    assert bounded["rays_speculated"] < spec["rays_speculated"]
    assert spec["epochs"] < bounded["epochs"] < base["epochs"]
    assert spec["committed"] == bounded["committed"] == base["committed"]


def test_config3_committed_does_not_depend_on_the_schedule(reference):
    committed = {reference[k]["committed"] for k in VARIANTS
                 if k.startswith("config3")}
    assert len(committed) == 1


# bench_torch.main in its own process: the curve cut to one rank on a small
# scene, the suite's JSON into argv[1]; an argv[2] of "fail" gives the suite
# an impossible domain count
ENTRY = """
import sys
from pathlib import Path

import bench_torch
from spray_tpu_torch.dist import scaling

bench_torch.SUITE_PATH = Path(sys.argv[1])
bench_torch.scaling_suite = lambda: scaling.curve(
    world_sizes=(1,), scene_kw=dict(n_blobs=2, tris_per_blob=80, seed=5),
    iters=1, device="cpu")
if sys.argv[2] == "fail":
    bench_torch.SUITE_VARIANTS = (
        ("config3_speculative", 0, 8, dict(speculate=True, lookahead=False)),)
bench_torch.main(sys.argv[3:])
"""
ARGS = ["--device", "cpu", "--suite", "--blobs", "8", "--tris-per-blob", "160",
        "--size", "16", "--spp", "1", "--bounces", "1", "--iters", "1"]


def _entry(path, mode):
    # one torch thread: the 16x16 frames are too small to share, and under
    # several test workers a thread pool a process mostly waits on itself
    return subprocess.run([sys.executable, "-c", ENTRY, str(path), mode, *ARGS],
                          cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_row_keys_are_the_reference_suites():
    """bench_torch.ROW_KEYS, the suite's schema, is that of bench.py's rows:
    BENCH_extra.json's keys, plus the two that bench.py writes for config 4
    since that file was made."""
    ref = json.loads((ROOT / "BENCH_extra.json").read_text())
    for name in VARIANTS:
        want = set(ref[name])
        if name.startswith("config4"):
            want |= {"lookahead_active", "host_to_hbm_mbps"}
        keys = bench_torch.ROW_KEYS[name.split("_")[0]]
        assert set(keys) == want and len(keys) == len(want), name


def test_suite_entry_writes_reference_rows(tmp_path):
    """One stdout line (the headline, naming the suite's file); the JSON has
    bench.py's five rows with exactly their keys (bench_torch.ROW_KEYS),
    profiling/scaling_curve.py's row keys, card null and no kernel launch
    on the CPU."""
    out = tmp_path / "extra.json"
    r = _entry(out, "ok")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert (ROOT / line["detail"]["suite"]).resolve() == out.resolve()
    ref = json.loads((ROOT / "BENCH_extra.json").read_text())
    extra = json.loads(out.read_text())
    assert set(extra) == set(ref) | {"card", "suite_s", "curve_s", "launches"}
    assert extra["card"] is None
    assert set(extra["launches"]) == set(VARIANTS)
    assert all(n == 0 for v in extra["launches"].values() for n in v.values())
    for name in VARIANTS:
        keys = bench_torch.ROW_KEYS[name.split("_")[0]]
        assert set(extra[name]) == set(keys), name
        assert 0 < extra[name]["speculation_efficiency"] <= 1
    assert len({extra[k]["committed"] for k in VARIANTS
                if k.startswith("config3")}) == 1
    assert extra["config3_baseline"]["speculated"] == 0
    assert list(extra["scaling_cpu_mesh"]) == ["1"]
    assert set(extra["scaling_cpu_mesh"]["1"]) == set(ref["scaling_cpu_mesh"]["1"])


def test_suite_entry_fails_loudly(tmp_path):
    """A suite that raises ends the run non-zero with its traceback, after
    the headline line, and writes no JSON."""
    out = tmp_path / "extra.json"
    r = _entry(out, "fail")
    assert r.returncode != 0
    assert len(r.stdout.strip().splitlines()) == 1
    assert "Traceback" in r.stderr and "ValueError" in r.stderr
    assert not out.exists()


def test_suite_curve_runs_cpu_ranks(monkeypatch):
    """The suite's curve (`scaling_cpu_mesh`) is asked for gloo CPU ranks,
    in a process of its own, as bench.py asks for a CPU mesh."""
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout='# x\n{"1": {}}\n')

    monkeypatch.setattr(bench_torch.subprocess, "run", run)
    assert bench_torch.scaling_suite() == {"1": {}}
    assert calls == [[sys.executable, "-m", "spray_tpu_torch.dist.scaling",
                      "--device", "cpu"]]
