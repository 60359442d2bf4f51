"""Whole runs of the harness: without a card, under the import guard, at a
tiny size on the CPU with faults planted under the timed path, and with a
configuration, traffic mix, metric and entry kind added as files only."""

import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import pytest
import torch

from benchmark import check, faults, guard, harness
from benchmark.entries._common import frame_seeds
from benchmark.tests._tiny import tiny_copy

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SEED = 2**31 + 4321


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_without_the_program_exits_non_zero(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's files."""
    (tmp_path / "benchmark").mkdir()
    for p in (ROOT / "benchmark").rglob("*.py"):
        dst = tmp_path / p.relative_to(ROOT)
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(p.read_bytes())
    (tmp_path / "BENCHMARK.json").write_bytes((ROOT / "BENCHMARK.json").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_import_guard_compares_whole_top_level_names():
    assert guard.offenders(["jax.numpy", "numpy"]) == ["jax"]
    assert guard.offenders(["spray_tpu.render"]) == ["spray_tpu"]
    assert guard.offenders(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]
    assert guard.offenders(["spray_tpu_torch", "spray_tpu_torch.render",
                            "jaxtyping", "torch"]) == []


def test_import_guard_trips_in_a_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "spray_tpu", object())
    with pytest.raises(SystemExit) as e:
        guard.check("test")
    assert e.value.code != 0
    monkeypatch.delitem(sys.modules, "spray_tpu")
    monkeypatch.setitem(sys.modules, "spray_tpu_torch.fake", object())
    guard.check("test")


def test_the_program_loads_no_banned_module():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.harness, benchmark.entries.pipeline, "
            "benchmark.entries.ooc; "
            "import spray_tpu_torch.render, spray_tpu_torch.sched.epochs, "
            "spray_tpu_torch.integrators.device; "
            "from benchmark import guard; print(guard.offenders())" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


def run_tiny(tiny, cell, trace=0, seconds=0.2):
    root, manifest = tiny
    return harness.run_cell(root, manifest, cell, SEED, seconds, trace,
                            time.perf_counter(), device="cpu",
                            bench=root / "benchmark")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_tiny_run_is_correct(tiny, cell):
    r = run_tiny(tiny, cell)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    want = {m["name"] for m in harness.metrics_for(tiny[1], cell, 0)}
    assert set(r["metrics"]) == want
    assert all(e["value"] <= e["limit"] for e in r["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", faults.applicable(1))
def test_a_fault_under_the_timed_path_makes_the_run_incorrect(tiny, cell,
                                                              fault):
    root, manifest = tiny
    r = harness.run_cell(root, manifest, cell, SEED, 0.2, 0,
                         time.perf_counter(), device="cpu",
                         bench=root / "benchmark", fault=fault)
    assert r["correct"] is False, r["checks"]
    assert r["failed"] == 1
    from spray_tpu_torch.integrators import wavefront  # noqa: PLC0415

    assert wavefront.sample_wavefront.__name__ == "sample_wavefront"


def test_a_traced_tiny_run_reports_per_layer_metrics(tiny):
    r = run_tiny(tiny, "wisp2m-ooc64s8.frame-spp1", trace=1)
    assert r["correct"] is True
    for name in ("build_s", "epochs", "spec_eff", "domain_loads"):
        assert name in r["metrics"]
    assert "breakdown" in r and "window_s" in r["device"]


OOC = "wisp2m-ooc64s8.frame-spp1"


def test_every_seed_renders_the_same_frames_in_its_own_order(tiny):
    root, manifest = tiny
    pool = json.loads((root / "benchmark" / "traffic" / "frame-spp1.json")
                      .read_text())["frame_seeds"]
    orders = []
    for seed in (SEED, SEED + 1, 7, SEED):
        ctx, _ = harness.make_context(root, manifest, OOC, seed, "cpu",
                                      bench=root / "benchmark")
        orders.append(frame_seeds(ctx))
    assert all(sorted(o) == sorted(pool) for o in orders)
    assert len({tuple(o) for o in orders[:3]}) == 3
    assert orders[3] == orders[0]


def test_the_check_judges_each_frame_by_its_own_render_seed(tiny):
    root, manifest = tiny
    ctx, entry_path = harness.make_context(root, manifest, OOC, SEED, "cpu",
                                           bench=root / "benchmark")
    ent = harness._load_module(entry_path, "benchmark_entry_ooc_test").Entry(ctx)
    seen = []
    for _ in range(3):
        out = ent.step()
        seen.append(ent.render_seed)
        output = ent.output(out)
        assert check.numbers(output, ctx)["pixel_mismatch"] == 0.0
    assert seen == frame_seeds(ctx)[:3]
    output["render_seed"] = seen[0]
    assert (check.numbers(output, ctx)["pixel_mismatch"]
            > 2 * ctx.limits["limits"]["pixel_mismatch"])


def test_a_cell_is_added_by_files_and_entries_only(tmp_path):
    """A new configuration, traffic mix, per-layer metric and entry kind,
    each a new file plus new BENCHMARK.json entries, run with no file of
    the benchmark edited."""
    root, manifest = tiny_copy(tmp_path)
    bench = root / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    conf = json.loads((bench / "configs" / "wisp2m-md21.json").read_text())
    conf.update(name="tiny-brute", entry="pipeline_once")
    conf["intersector"] = {"module": "spray_tpu_torch.oracle.brute",
                           "class": "BruteIntersector", "options": {}}
    (bench / "configs" / "tiny-brute.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic" / "frame-spp4.json").read_text())
    traffic.update(spp=2, bounces=1)
    (bench / "traffic" / "frame-spp2b1.json").write_text(json.dumps(traffic))
    (bench / "limits" / "tiny-brute.frame-spp2b1.json").write_text(
        json.dumps({"check_pixels": 64, "limits": {"pixel_mismatch": 0.01}}))
    (bench / "entries" / "pipeline_once.py").write_text(
        "from benchmark.entries._common import build_intersector, program_inputs\n"
        "class Entry:\n"
        "    def __init__(self, ctx, reuse=None):\n"
        "        from spray_tpu_torch.render import make_pipeline\n"
        "        scene, camera, cfg = program_inputs(ctx)\n"
        "        self.intersector, self.build_s = build_intersector(ctx, scene, reuse)\n"
        "        self.pipe = make_pipeline(scene, camera, cfg, intersector=self.intersector, device=ctx.device)\n"
        "    def step(self):\n"
        "        return self.pipe.run()\n"
        "    def output(self, out):\n"
        "        return {'image': out[0]}\n"
        "    def counters(self):\n"
        "        return {'frames': 1}\n")
    (bench / "metrics" / "build_ms.py").write_text(
        "def read(rec):\n    return rec.build_s * 1e3\n")
    manifest["configs"].append({"name": "tiny-brute", "source": "a test",
                                "file": "benchmark/configs/tiny-brute.json",
                                "reduced": [], "why": "a test"})
    cell = "tiny-brute.frame-spp2b1"
    manifest["workloads"].append({"name": cell, "config": "tiny-brute",
                                  "traffic": "frame-spp2b1", "chips": 1,
                                  "why": "a test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "frame_ms":
            m["workloads"].append(cell)
    manifest["per_layer"].append({"name": "build_ms", "unit": "ms",
                                  "better": "lower", "source": "host_clock",
                                  "layer": "host build", "moves": "setup_s",
                                  "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    for p, data in before.items():
        assert p.read_bytes() == data
    for trace in (0, 1):
        r = harness.run_cell(root, manifest, cell, SEED, 0.2, trace,
                             time.perf_counter(), device="cpu", bench=bench)
        assert r["correct"] is True
        assert ("build_ms" in r["metrics"]) == bool(trace)
        assert ("frame_ms" in r["metrics"]) == (not trace)
        assert ("setup_s" in r["metrics"]) == (not trace)


@pytest.mark.card
def test_each_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    cards = torch.cuda.device_count()
    chips = {w["name"]: w["chips"] for w in MANIFEST["workloads"]}
    skipped = [cell for cell in CELLS if chips[cell] > cards]
    if skipped:
        warnings.warn(f"skipped, more chips than the {cards} card(s) here: "
                      f"{', '.join(skipped)}", stacklevel=1)
    for cell in CELLS:
        if cell in skipped:
            continue
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
             str(SEED), "--seconds", "2", "--trace", "0"],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
