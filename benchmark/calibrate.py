"""Readings that the limits of `benchmark/limits/<cell>.json` are set from,
on the card at the cell's own size, in one process over one build:

- the program's numbers on each of --seeds (sound runs: the lower reading);
- the control's, on each of --control-seeds: the plain reference computed
  in bfloat16 (the configurations state float32; no op of the reference
  is a matrix product, so TF32 would change nothing) put in the program's
  place;
- with --faults, each fault of `benchmark.faults` that the cell can have
  (`faults.applicable`) planted under the program, on each of
  --control-seeds (--seeds where none are given).

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--faults] [--out FILE]

A cell of `chips` N > 1 is read through the harness's rank runner
(`benchmark/ranks.py`), N ranks each building the entry once on its own
card and handing its build to the next seed (`reuse`); rank 0 reads the
numbers while the others wait.  Prints one JSON line per reading, and
writes them all to --out.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, faults, guard, harness, ranks  # noqa: E402
from benchmark.reference.render import Reference  # noqa: E402


# a whole calibration of a cell of many ranks: a build and a frame a reading
TIMEOUT_S = 3000.0


def ints(text):
    return [int(x) for x in text.split(",") if x]


def control_output(ctx, ref_low):
    """What the control puts in the program's place: the sampled pixels of
    the image (the rest left zero), or the loss and gradients."""
    cfg = check.reference_cfg(ctx.traffic, ctx.seed)
    if ctx.traffic["backward"]:
        loss, grads = ref_low.loss_and_grads(ctx.camera, cfg,
                                             ctx.traffic["loss_weights"])
        return {"loss": loss, "grads": grads}
    w, h = ctx.camera["width"], ctx.camera["height"]
    ids = check.sample_pixels(ctx.seed, w * h, ctx.limits["check_pixels"])
    px = ref_low.pixels(ctx.camera, cfg, torch.as_tensor(ids,
                                                         device=ref_low.device))
    img = np.zeros((w * h, 3), np.float32)
    img[ids] = px.float().cpu().numpy()
    return {"image": img.reshape(h, w, 3)}


def readings(ctx, entry_path, seeds, control_seeds, fault_names,
             fault_seeds, emit, sync=None):
    """Every reading of the cell, in this process (one chip) or in one rank
    of many (`sync`, a ranks.Lockstep): the sound runs, the faults, then,
    on rank 0 alone, the control.  Rank 0 emits each reading's numbers."""
    entry = harness._load_module(entry_path, "benchmark_entry")
    # each calibration seed renders its own frame (a run's window cycles
    # through the traffic's pool of frame seeds, if it has one)
    ctx.traffic.pop("frame_seeds", None)
    n_faces = int(ctx.scene["faces"].shape[0])
    lead = ctx.rank == 0
    ref = Reference(ctx.scene, ctx.device) if lead else None
    isect = None

    def program(seed, fault=None):
        nonlocal isect
        ctx.seed = seed
        ent = entry.Entry(ctx, isect)
        isect = ent.intersector
        if fault is None:
            out = ent.step()
        else:
            with faults.planted(fault, ent, n_faces):
                out = ent.step()
        output = ent.output(out) if lead else None
        del ent, out
        return output

    def read(kind, seed, fault=None):
        t0 = time.perf_counter()
        output = program(seed, fault)
        if lead:
            emit(kind, seed, check.numbers(output, ctx, ref),
                 time.perf_counter() - t0)
        if sync is not None:
            sync.barrier()  # the others wait while rank 0 reads

    for seed in seeds:
        read("sound", seed)
    for name in fault_names:
        for seed in fault_seeds:
            read(f"fault_{name}", seed, name)
    if control_seeds and lead:
        ref_low = Reference(ctx.scene, ctx.device, torch.bfloat16)
        for seed in control_seeds:
            t0 = time.perf_counter()
            ctx.seed = seed
            values = check.numbers(control_output(ctx, ref_low), ctx, ref)
            emit("control_bf16", seed, values, time.perf_counter() - t0)


def _emitter(workload, rows):
    def emit(kind, seed, values, seconds):
        row = {"cell": workload, "kind": kind, "seed": seed,
               "values": values, "s": seconds}
        print(json.dumps(row), flush=True)
        rows.append(row)

    return emit


def _rank(rank, world, device, sync, root, manifest, workload, plan):
    """One rank of a cell of many: its readings (rank 0's rows)."""
    guard.check(f"rank {rank} start")
    seeds = plan[0]
    ctx, entry_path = harness.make_context(root, manifest, workload, seeds[0],
                                           device)
    ctx.rank, ctx.world = rank, world
    rows = []
    readings(ctx, entry_path, *plan, _emitter(workload, rows), sync)
    guard.check(f"rank {rank} end")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=ints, required=True)
    p.add_argument("--control-seeds", type=ints, default=[])
    p.add_argument("--faults", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in manifest["workloads"]}[args.workload]
    chips = int(cell["chips"])
    fault_names = faults.applicable(chips) if args.faults else ()
    plan = (args.seeds, args.control_seeds, fault_names,
            args.control_seeds or args.seeds)
    if chips > 1:
        rows = ranks.run_world(_rank, chips,
                               (str(ROOT), manifest, args.workload, plan),
                               device=args.device, timeout_s=TIMEOUT_S)[0]
    else:
        ctx, entry_path = harness.make_context(ROOT, manifest, args.workload,
                                               args.seeds[0], args.device)
        rows = []
        readings(ctx, entry_path, *plan, _emitter(args.workload, rows))
    guard.check("end")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
