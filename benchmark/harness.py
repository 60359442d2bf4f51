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

from benchmark import check, profile, scenes
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


def _traced(ent, ctx, steps, seconds, clock):
    """Profile up to `steps` steps (at least one, no more than fit in
    `seconds`): (last output, Trace, steps done, wall s)."""
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
            if done >= steps or clock() - t0 >= seconds:
                break
        _sync(ctx.device)
        wall = clock() - t0
    return out, profile.from_profiler(prof), done, wall


def run_cell(root, manifest, cell_name, seed, seconds, trace, t_start,
             device="cuda", bench=BENCH, clock=time.perf_counter, plant=None):
    """One run of the cell: the result line's dict, with the numbers the
    check compared under its last key, "checks".  `plant(ent, ctx)`, a
    context manager, breaks the timed path from the warm-up to the close
    of the window (the tests' faults)."""
    ctx, entry_path = make_context(root, manifest, cell_name, seed, device,
                                   bench)
    entry = _load_module(entry_path, f"benchmark_entry_{entry_path.stem}")
    with contextlib.ExitStack() as stack:
        result, output = _measure(entry.Entry(ctx), ctx, manifest, cell_name,
                                  seconds, trace, t_start, bench, clock,
                                  stack, plant)
    # the check runs once the window has closed, the peak has been read
    # and the program's state is freed
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = clock()
    correct, table = check.judge(check.numbers(output, ctx), ctx.limits)
    print(f"{cell_name}: check {clock() - t0:.4f} s", file=sys.stderr,
          flush=True)
    result.update(correct=correct, failed=0 if correct else 1, checks=table)
    order = ("correct", "attempted", "failed", "metrics", "device",
             "breakdown", "checks")
    return {k: result[k] for k in order if k in result}


def _measure(ent, ctx, manifest, cell_name, seconds, trace, t_start, bench,
             clock, stack, plant):
    """Warm up, measure and read the metrics: (result dict, the output of
    the window's last step)."""
    if plant is not None:
        stack.enter_context(plant(ent, ctx))
    t0 = clock()
    out = ent.step()  # the warm-up step: every shape the window uses
    print(f"{cell_name}: build {ent.build_s:.4f} s, warm-up step "
          f"{clock() - t0:.4f} s", file=sys.stderr, flush=True)
    rec = Record(setup_s=clock() - t_start, build_s=ent.build_s)
    cuda = ctx.device.type == "cuda"
    peak = 0
    if not trace:
        rec.times, rec.window_s, out = run_window(ent.step, seconds, clock)
        attempted = len(rec.times)
    else:
        rec.counters_before = ent.counters()
        if cuda:
            peak = torch.cuda.max_memory_allocated(ctx.device)
            torch.cuda.reset_peak_memory_stats(ctx.device)
        out, rec.trace, rec.traced_steps, rec.traced_wall_s = _traced(
            ent, ctx, int(ctx.traffic["trace_steps"]), seconds, clock)
        rec.counters_after = ent.counters()
        if cuda:
            rec.window_peak_bytes = torch.cuda.max_memory_allocated(ctx.device)
        attempted = rec.traced_steps
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(ctx.device))
    metrics = {}
    for m in metrics_for(manifest, cell_name, trace):
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
        result["breakdown"] = {"device_ops": profile.top_device_ops(rec.trace),
                               "idle_gaps": profile.idle_gaps(rec.trace)}
    return result, ent.output(out)
