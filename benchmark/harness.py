"""One run of one cell: set up, warm up, measure, check, report.

Everything that belongs to one configuration, traffic mix, per-layer
metric or entry kind is a file of its own, found by name:

- `BENCHMARK.json`'s `configs[].file`: the deployment (scene, camera,
  intersector, entry kind);
- `benchmark/traffic/<traffic>.json`: the frame each step renders;
- `benchmark/limits/<cell>.json`: the pixels the check samples and the
  limit of each number it compares;
- `benchmark/entries/<entry>.py`: how the kind of deployment is built and
  stepped;
- `benchmark/metrics/<metric>.py` (or `<metric up to its first dot>.py`):
  the reader of a metric.

A cell whose `chips` is 1 runs here, in this process.  A cell of N > 1
chips runs in N ranks, one a card (`benchmark/ranks.py`): each builds the
entry on its own card and steps in lockstep with rank 0, whose clock ends
the window; the readers read rank 0's record, the check judges rank 0's
output, and the result line's `device` is formed from every rank's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import check, faults, guard, profile, ranks, scenes
from benchmark.reference.render import make_camera
from benchmark.window import run_window

BENCH = Path(__file__).resolve().parent


@dataclasses.dataclass
class Context:
    """What the entry, the readers and the check are given."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    scene: dict  # host numpy arrays the benchmark made
    camera: dict  # the camera basis the benchmark made
    seed: int
    device: torch.device
    rank: int = 0  # this process's rank, in a cell of chips > 1
    world: int = 1  # the cell's ranks, one a card


@dataclasses.dataclass
class Record:
    """What the readers read."""

    setup_s: float
    build_s: float
    times: list = dataclasses.field(default_factory=list)  # s per step
    window_s: float = 0.0
    trace: profile.Trace | None = None
    traced_steps: int = 0
    traced_wall_s: float = 0.0
    window_peak_bytes: int | None = None
    counters_before: dict = dataclasses.field(default_factory=dict)
    counters_after: dict = dataclasses.field(default_factory=dict)

    def counter_delta(self, key):
        if key not in self.counters_after or key not in self.counters_before:
            return None
        return self.counters_after[key] - self.counters_before[key]


def load_json(path):
    with open(path) as f:
        return json.load(f)


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(metric, bench=BENCH):
    """benchmark/metrics/<metric>.py, else <metric up to its first dot>.py."""
    for stem in (metric, metric.split(".")[0]):
        p = bench / "metrics" / f"{stem}.py"
        if p.exists():
            return p
    raise FileNotFoundError(f"no reader for metric {metric!r}")


def cell_files(root, manifest, cell_name, bench=BENCH):
    """(cell, config path, traffic path, limits path, entry path)."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"unknown workload {cell_name!r}; known: "
                         f"{', '.join(sorted(cells))}")
    cell = cells[cell_name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config_path = Path(root) / conf["file"]
    entry = load_json(config_path)["entry"]
    return (cell, config_path, bench / "traffic" / f"{cell['traffic']}.json",
            bench / "limits" / f"{cell_name}.json",
            bench / "entries" / f"{entry}.py")


def metrics_for(manifest, cell_name, trace):
    """The cell's end-to-end metrics, or with trace its per-layer ones."""
    group = manifest["per_layer"] if trace else manifest["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def make_context(root, manifest, cell_name, seed, device, bench=BENCH):
    cell, config_path, traffic_path, limits_path, entry_path = cell_files(
        root, manifest, cell_name, bench)
    config = load_json(config_path)
    traffic = load_json(traffic_path)
    cam = make_camera(**config["camera"], width=traffic["width"],
                      height=traffic["height"])
    ctx = Context(name=cell_name, config=config, traffic=traffic,
                  limits=load_json(limits_path),
                  scene=scenes.make_scene(config["scene"], bench),
                  camera=cam,
                  seed=int(seed), device=torch.device(device))
    return ctx, entry_path


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traced(ent, ctx, steps, seconds, clock, agree=None):
    """Profile up to `steps` steps (at least one, no more than fit in
    `seconds`; in a cell of many ranks, as many as rank 0 decides, through
    `agree`): (last output, Trace, steps done, wall s)."""
    from torch.profiler import ProfilerActivity  # noqa: PLC0415
    from torch.profiler import profile as torch_profile  # noqa: PLC0415

    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts) as prof:
        _sync(ctx.device)
        t0 = clock()
        done = 0
        while True:
            out = ent.step()
            done += 1
            stop = done >= steps or clock() - t0 >= seconds
            if agree is not None:
                stop = agree(stop)
            if stop:
                break
        _sync(ctx.device)
        wall = clock() - t0
    return out, profile.from_profiler(prof), done, wall


def _ordered(result):
    order = ("correct", "attempted", "failed", "metrics", "device",
             "breakdown", "checks")
    return {k: result[k] for k in order if k in result}


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _judge(result, output, ctx, cell_name, clock):
    t0 = clock()
    correct, table = check.judge(check.numbers(output, ctx), ctx.limits)
    print(f"{cell_name}: check {clock() - t0:.4f} s", file=sys.stderr,
          flush=True)
    result.update(correct=correct, failed=0 if correct else 1, checks=table)


def run_cell(root, manifest, cell_name, seed, seconds, trace, t_start,
             device="cuda", bench=BENCH, clock=time.perf_counter, fault=None,
             timeout_s=ranks.TIMEOUT_S):
    """One run of the cell: the result line's dict, with the numbers the
    check compared under its last key, "checks".  `fault`, one of
    `benchmark.faults.FAULTS`, breaks the timed path from the warm-up to
    the close of the window, in every rank (the tests' faults).  A cell of
    chips > 1 runs in as many ranks (`run_ranks`), within `timeout_s`."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    chips = int(cells[cell_name]["chips"]) if cell_name in cells else 1
    if chips > 1:
        return run_ranks(root, manifest, cell_name, seed, seconds, trace,
                         t_start, chips, device, bench, clock, fault,
                         timeout_s)
    ctx, entry_path = make_context(root, manifest, cell_name, seed, device,
                                   bench)
    entry = _load_module(entry_path, f"benchmark_entry_{entry_path.stem}")
    with contextlib.ExitStack() as stack:
        result, output = _measure(entry.Entry(ctx), ctx, manifest, cell_name,
                                  seconds, trace, t_start, bench, clock,
                                  stack, fault)
    # the check runs once the window has closed, the peak has been read
    # and the program's state is freed
    _free(ctx.device)
    _judge(result, output, ctx, cell_name, clock)
    return _ordered(result)


def _card(device):
    """What tells one card from another: its UUID ("cpu" on the host)."""
    if device.type == "cuda":
        return str(torch.cuda.get_device_properties(device).uuid)
    return "cpu"


def _cell_rank(rank, world, device, sync, root, manifest, cell_name, seed,
               seconds, trace, t_start, bench, fault):
    """One rank of a cell of many (run by `ranks.run_world`): the entry on
    this rank's card, the warm-up, the window in lockstep with rank 0, and,
    on rank 0, the readers and then the check, once every rank has freed
    its state.  `t_start` is on the system-wide monotonic clock."""
    guard.check(f"rank {rank} start")
    clock = time.monotonic
    ctx, entry_path = make_context(root, manifest, cell_name, seed, device,
                                   bench)
    ctx.rank, ctx.world = rank, world
    entry = _load_module(entry_path, f"benchmark_entry_{entry_path.stem}")
    with contextlib.ExitStack() as stack:
        result, output = _measure(entry.Entry(ctx), ctx, manifest, cell_name,
                                  seconds, trace, t_start, bench, clock,
                                  stack, fault, sync)
    result["device"]["card"] = _card(ctx.device)
    if rank != 0:
        output = None
    _free(ctx.device)
    sync.barrier()  # every rank has freed its state
    if rank == 0:
        _judge(result, output, ctx, cell_name, clock)
    guard.check(f"rank {rank} end")
    return result


def _world_device(reports, trace):
    """The result line's `device` from every rank's: `count` the distinct
    cards they ran on, `kind` their common name, `memory_peak_bytes` the
    largest rank's peak; traced, `busy_s` the mean of the ranks' busy
    unions and `window_s` rank 0's wall time."""
    devs = [r["device"] for r in reports]
    kinds = sorted({d["kind"] for d in devs})
    if len(kinds) != 1:
        raise ranks.RankFailure(f"the ranks ran on cards of different kinds: "
                                f"{kinds}")
    info = {"platform": devs[0]["platform"], "kind": kinds[0],
            "count": len({d["card"] for d in devs}),
            "memory_peak_bytes": max(d["memory_peak_bytes"] for d in devs)}
    if trace:
        info["busy_s"] = sum(d["busy_s"] for d in devs) / len(devs)
        info["window_s"] = devs[0]["window_s"]
    return info


def run_ranks(root, manifest, cell_name, seed, seconds, trace, t_start,
              world, device="cuda", bench=BENCH, clock=time.perf_counter,
              fault=None, timeout_s=ranks.TIMEOUT_S):
    """One run of a cell of `world` chips, one rank a card: rank 0's result
    with `device` formed from every rank's.  `t_start` is read on `clock`;
    the ranks read the system-wide monotonic clock, so setup_s spans the
    spawn of the ranks and their joining the group.  Raises RankFailure
    if a rank fails or steps other than rank 0 did."""
    t_start = time.monotonic() - (clock() - t_start)
    reports = ranks.run_world(
        _cell_rank, world,
        (root, manifest, cell_name, seed, seconds, trace, t_start, bench,
         fault),
        device=device, timeout_s=timeout_s)
    for r, rep in enumerate(reports):
        d = rep["device"]
        busy = f", busy_s {d['busy_s']!r}" if trace else ""
        print(f"{cell_name} rank {r}: card {d['card']}, steps "
              f"{rep['attempted']}, memory_peak_bytes "
              f"{d['memory_peak_bytes']}{busy}", file=sys.stderr, flush=True)
    off = [r for r, rep in enumerate(reports)
           if rep["attempted"] != reports[0]["attempted"]]
    if off:
        raise ranks.RankFailure(f"rank {off[0]} stepped "
                                f"{reports[off[0]]['attempted']} times, rank 0 "
                                f"{reports[0]['attempted']}")
    result = reports[0]
    result["device"] = _world_device(reports, trace)
    return _ordered(result)


def _measure(ent, ctx, manifest, cell_name, seconds, trace, t_start, bench,
             clock, stack, fault, sync=None):
    """Warm up, measure and read the metrics: (result dict, the output of
    the window's last step).  `sync`, a ranks.Lockstep in a cell of many
    ranks, starts the window on every rank at once and ends it where rank
    0's clock does; only rank 0 reads the metrics."""
    if fault is not None:
        stack.enter_context(faults.planted(fault, ent,
                                           int(ctx.scene["faces"].shape[0])))
    who = cell_name if ctx.world == 1 else f"{cell_name} rank {ctx.rank}"
    t0 = clock()
    out = ent.step()  # the warm-up step: every shape the window uses
    print(f"{who}: build {ent.build_s:.4f} s, warm-up step "
          f"{clock() - t0:.4f} s", file=sys.stderr, flush=True)
    agree = None
    if sync is not None:
        sync.barrier()  # every rank warm before rank 0's window starts
        agree = sync.agree
    rec = Record(setup_s=clock() - t_start, build_s=ent.build_s)
    cuda = ctx.device.type == "cuda"
    peak = 0
    if not trace:
        rec.times, rec.window_s, out = run_window(ent.step, seconds, clock,
                                                  agree)
        attempted = len(rec.times)
    else:
        rec.counters_before = ent.counters()
        if cuda:
            peak = torch.cuda.max_memory_allocated(ctx.device)
            torch.cuda.reset_peak_memory_stats(ctx.device)
        out, rec.trace, rec.traced_steps, rec.traced_wall_s = _traced(
            ent, ctx, int(ctx.traffic["trace_steps"]), seconds, clock, agree)
        rec.counters_after = ent.counters()
        if cuda:
            rec.window_peak_bytes = torch.cuda.max_memory_allocated(ctx.device)
        attempted = rec.traced_steps
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(ctx.device))
    metrics = {}
    read = metrics_for(manifest, cell_name, trace) if ctx.rank == 0 else []
    for m in read:
        reader = _load_module(reader_path(m["name"], bench),
                              f"benchmark_metric_{m['name'].replace('.', '_')}")
        v = reader.read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else ctx.device.type,
        "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"attempted": attempted, "metrics": metrics,
              "device": device_info}
    if trace:
        device_info["busy_s"] = profile.busy_us(
            (iv.start_us, iv.end_us) for iv in rec.trace.device) / 1e6
        device_info["window_s"] = rec.traced_wall_s
        if ctx.rank == 0:
            result["breakdown"] = {
                "device_ops": profile.top_device_ops(rec.trace),
                "idle_gaps": profile.idle_gaps(rec.trace)}
    return result, ent.output(out)
