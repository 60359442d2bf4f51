"""The rank runner on the CPU: a cell of chips > 1 added by files and
entries only (2 gloo ranks rendering through the program's in-situ
renderer, 8 domains), run sound and with each fault planted in every rank;
the lockstep window, a failing rank, the cards counted, and a one-chip cell
that starts no process and no process group."""

import json
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from benchmark import faults, harness, ranks, run
from benchmark.tests._tiny import tiny_copy

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 1234
INSITU = "tiny-insitu.frame-spp4"
LOCAL = "tiny-local.frame-spp4"
WORLD = 2
TIMEOUT_S = 120.0  # each run of a world here; a test's subprocess gets more

INSITU_ENTRY = '''"""The in-situ renderer of spray_tpu_torch.dist.epochs: domains owned by
the ranks, rays exchanged between them in all-to-all epochs."""
import os
import time

from benchmark.entries._common import program_inputs


class Entry:
    def __init__(self, ctx, reuse=None):
        from spray_tpu_torch.dist import epochs

        scene, camera, cfg = program_inputs(ctx)
        t0 = time.perf_counter()
        self.render = epochs.make_insitu_renderer(
            scene, camera, cfg, n_domains=ctx.config["n_domains"],
            device=ctx.device)
        self.build_s = time.perf_counter() - t0
        # built anew each frame by the renderer: the faults wrap its class
        self.intersector = epochs.CollectiveEpochIntersector
        self.calls = 0
        self.fail_at = ctx.config.get("fail_rank_at")
        self.rank = ctx.rank
        pids = ctx.config.get("pid_dir")
        if pids:
            open(os.path.join(pids, str(os.getpid())), "w").close()

    def step(self):
        self.calls += 1
        if self.fail_at is not None and self.rank == 1 \\
                and self.calls >= self.fail_at:
            raise RuntimeError("rank 1 fails on purpose")
        return self.render()

    def output(self, out):
        return {"image": out}

    def counters(self):
        return dict(self.render.last_stats or {})
'''

# each rank alone, its frame rendered once and then handed back after a
# pause twice as long on rank 1: without the lockstep the two would step
# different numbers of times in one window
LOCAL_ENTRY = '''import time

from benchmark.entries._common import build_intersector, program_inputs


class Entry:
    def __init__(self, ctx, reuse=None):
        from spray_tpu_torch.render import make_pipeline

        scene, camera, cfg = program_inputs(ctx)
        self.intersector, self.build_s = build_intersector(ctx, scene, reuse)
        self.frame = make_pipeline(scene, camera, cfg,
                                   intersector=self.intersector,
                                   device=ctx.device).run()
        self.pause = 0.01 * (ctx.rank + 1)

    def step(self):
        time.sleep(self.pause)
        return self.frame

    def output(self, out):
        return {"image": out[0]}

    def counters(self):
        return {}
'''


def add_cells(dst):
    """A tiny copy of the benchmark with two cells of 2 chips added as
    files and entries only: (root, manifest)."""
    root, manifest = tiny_copy(dst)
    bench = root / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    base = json.loads((bench / "configs" / "wisp2m-md21.json").read_text())
    for name, entry, source in (("tiny-insitu", "insitu_tiny", INSITU_ENTRY),
                                ("tiny-local", "local_tiny", LOCAL_ENTRY)):
        conf = dict(base, name=name, entry=entry, n_domains=8)
        (bench / "configs" / f"{name}.json").write_text(json.dumps(conf))
        (bench / "entries" / f"{entry}.py").write_text(source)
        cell = f"{name}.frame-spp4"
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(
            {"check_pixels": 256, "limits": {"pixel_mismatch": 0.03}}))
        manifest["configs"].append({"name": name, "source": "a test",
                                    "file": f"benchmark/configs/{name}.json",
                                    "reduced": [], "why": "a test"})
        manifest["workloads"].append({"name": cell, "config": name,
                                      "traffic": "frame-spp4", "chips": WORLD,
                                      "why": "a test"})
        for m in manifest["end_to_end"]:
            if m["name"] == "frame_ms":
                m["workloads"].append(cell)
        for m in manifest["per_layer"]:
            if m["name"] in ("build_s", "idle.frame"):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    for p, data in before.items():
        assert p.read_bytes() == data
    return root, manifest


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return add_cells(tmp_path_factory.mktemp("ranks"))


def run_copy(copy, cell, trace=0, seconds=0.3, **kw):
    root, manifest = copy
    return harness.run_cell(root, manifest, cell, SEED, seconds, trace,
                            time.perf_counter(), device="cpu",
                            bench=root / "benchmark", timeout_s=TIMEOUT_S, **kw)


def test_a_sound_run_of_two_ranks_is_correct(copy):
    r = run_copy(copy, INSITU)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert r["attempted"] >= 1
    assert set(r["metrics"]) == {"frame_ms", "setup_s"}
    # gloo ranks share the one host: one device, counted once
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                           "memory_peak_bytes": 0}
    assert not multiprocessing.active_children()


def test_a_traced_run_of_two_ranks_reports_rank_0s_readings(copy):
    r = run_copy(copy, INSITU, trace=1)
    assert r["correct"] is True, r["checks"]
    # the host has no device events: idle.frame finds nothing to read
    assert set(r["metrics"]) == {"build_s"}
    assert r["device"]["busy_s"] == 0.0
    assert r["device"]["window_s"] > 0
    assert "breakdown" in r


def test_each_rank_steps_as_often_as_rank_0(copy, capfd):
    r = run_copy(copy, LOCAL, seconds=0.5)
    err = capfd.readouterr().err
    steps = {}
    for line in err.splitlines():
        if line.startswith(f"{LOCAL} rank ") and ", steps " in line:
            rank = int(line.split(" rank ")[1].split(":")[0])
            steps[rank] = int(line.split(", steps ")[1].split(",")[0])
    assert sorted(steps) == list(range(WORLD))
    assert r["attempted"] >= 5
    assert set(steps.values()) == {r["attempted"]}
    assert r["correct"] is True


@pytest.mark.parametrize("fault", faults.applicable(WORLD))
def test_each_fault_in_every_rank_makes_the_run_incorrect(copy, fault):
    r = run_copy(copy, INSITU, fault=fault)
    assert r["correct"] is False, r["checks"]
    assert r["failed"] == 1


def test_the_exchange_fault_applies_only_across_chips():
    assert "exchange" in faults.applicable(4)
    assert "exchange" not in faults.applicable(1)
    assert set(faults.applicable(1)) | {"exchange"} == set(faults.FAULTS)


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return Path(f"/proc/{pid}/stat").exists() and \
        Path(f"/proc/{pid}/stat").read_text().split(") ")[1][0] != "Z"


DRIVE = '''import sys, torch
sys.path.insert(0, {root!r})
sys.path.append({repo!r})
from benchmark import harness, run
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: {cards}
cell = harness.run_cell
def on_the_cpu(*args, **kw):
    return cell(*args, device="cpu", timeout_s={timeout}, **kw)
harness.run_cell = on_the_cpu
sys.exit(run.main(["--workload", {cell!r}, "--seed", "{seed}", "--seconds",
                   "0.3", "--trace", "0"]))
'''


def drive_run_py(root, cell, cards):
    """benchmark/run.py's main in a process of its own, told it has `cards`
    CUDA cards and running the cell's ranks with gloo on the host."""
    code = DRIVE.format(root=str(root), repo=str(ROOT), cards=cards, cell=cell,
                        seed=SEED, timeout=TIMEOUT_S)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=root, env=env,
                          timeout=TIMEOUT_S + 60)


def test_a_rank_that_raises_ends_the_run_with_no_result_and_no_rank_left(
        tmp_path):
    root, manifest = add_cells(tmp_path / "copy")
    pids = tmp_path / "pids"
    pids.mkdir()
    path = root / "benchmark" / "configs" / "tiny-insitu.json"
    conf = json.loads(path.read_text())
    conf.update(fail_rank_at=2, pid_dir=str(pids))
    path.write_text(json.dumps(conf))
    t0 = time.monotonic()
    p = drive_run_py(root, INSITU, WORLD)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "rank 1 fails on purpose" in p.stderr
    assert "RankFailure" in p.stderr
    assert time.monotonic() - t0 < TIMEOUT_S
    started = [int(f.name) for f in pids.iterdir()]
    assert len(started) == WORLD
    assert not [pid for pid in started if _alive(pid)]


def test_a_run_that_used_fewer_cards_than_its_chips_prints_no_line(copy):
    root, _ = copy
    p = drive_run_py(root, INSITU, WORLD)
    # gloo ranks share the host: one device used where two were asked for
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 2 CUDA device(s); the run used 1" in p.stderr


def test_a_cell_with_more_chips_than_cards_exits_non_zero_with_no_line(copy):
    root, _ = copy
    p = drive_run_py(root, INSITU, WORLD - 1)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 2 CUDA device(s); found 1" in p.stderr


def test_count_is_the_distinct_cards_the_ranks_ran_on():
    def rep(card, kind="NVIDIA H100 80GB HBM3", peak=10, busy=1.0, wall=2.0):
        return {"device": {"platform": "gpu", "kind": kind, "count": 1,
                           "memory_peak_bytes": peak, "busy_s": busy,
                           "window_s": wall, "card": card}}

    reps = [rep("a", peak=5, busy=1.0, wall=3.0), rep("b", peak=9, busy=2.0),
            rep("c", busy=3.0), rep("d", busy=6.0)]
    d = harness._world_device(reps, trace=1)
    assert d == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                 "count": 4, "memory_peak_bytes": 10, "busy_s": 3.0,
                 "window_s": 3.0}
    assert harness._world_device([rep("a"), rep("a")], 0)["count"] == 1
    with pytest.raises(ranks.RankFailure):
        harness._world_device([rep("a"), rep("b", kind="other")], 0)


def test_a_one_chip_run_starts_no_process_and_no_process_group(monkeypatch,
                                                               tmp_path):
    root, manifest = tiny_copy(tmp_path)

    def refuse(*args, **kw):
        raise AssertionError("a one-chip run started a process or a group")

    monkeypatch.setattr(multiprocessing.process.BaseProcess, "start", refuse)
    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(dist, "new_group", refuse)
    monkeypatch.setattr(ranks, "run_world", refuse)
    cell = "wisp2m-md21.frame-spp4"
    r = harness.run_cell(root, manifest, cell, SEED, 0.2, 0,
                         time.perf_counter(), device="cpu",
                         bench=root / "benchmark")
    assert r["correct"] is True and r["device"]["count"] == 1
    assert not dist.is_initialized()


def test_calibrate_reads_a_cell_of_many_ranks_with_its_faults(copy,
                                                              tmp_path):
    root, _ = copy
    out = tmp_path / "readings.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run(
        [sys.executable, "benchmark/calibrate.py", "--workload", INSITU,
         "--seeds", "1", "--faults", "--device", "cpu", "--out",
         str(out)],
        capture_output=True, text=True, cwd=root, env=env,
        timeout=2 * TIMEOUT_S)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = json.loads(out.read_text())
    kinds = [r["kind"] for r in rows]
    assert kinds == ["sound"] + [f"fault_{f}" for f in faults.FAULTS]
    sound = max(r["values"]["pixel_mismatch"] for r in rows
                if r["kind"] == "sound")
    exchange = min(r["values"]["pixel_mismatch"] for r in rows
                   if r["kind"] == "fault_exchange")
    assert sound <= 0.03 < exchange
