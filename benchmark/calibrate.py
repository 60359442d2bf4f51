"""Readings that the limits of `benchmark/limits/<cell>.json` are set from,
on the card at the cell's own size, in one process over one build:

- the program's numbers on each of --seeds (sound runs: the lower reading);
- the control's, on each of --control-seeds: the plain reference computed
  in bfloat16 (the configurations state float32; no op of the reference
  is a matrix product, so TF32 would change nothing) put in the program's
  place;
- with --faults, each fault of `benchmark.faults` planted under the
  program, on each of --control-seeds.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--faults] [--out FILE]

Prints one JSON line per reading, and writes them all to --out.
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

from benchmark import check, faults, guard, harness  # noqa: E402
from benchmark.reference.render import Reference  # noqa: E402


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
    ctx, entry_path = harness.make_context(ROOT, manifest, args.workload,
                                           args.seeds[0], args.device)
    entry = harness._load_module(entry_path, "benchmark_entry")
    # each calibration seed renders its own frame (a run's window cycles
    # through the traffic's pool of frame seeds, if it has one)
    ctx.traffic.pop("frame_seeds", None)
    n_faces = int(ctx.scene["faces"].shape[0])
    ref = Reference(ctx.scene, ctx.device)
    isect = None
    rows = []

    def emit(kind, seed, values, seconds):
        row = {"cell": args.workload, "kind": kind, "seed": seed,
               "values": values, "s": seconds}
        print(json.dumps(row), flush=True)
        rows.append(row)

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
        output = ent.output(out)
        del ent, out
        return output

    for seed in args.seeds:
        t0 = time.perf_counter()
        values = check.numbers(program(seed), ctx, ref)
        emit("sound", seed, values, time.perf_counter() - t0)
    if args.control_seeds:
        ref_low = Reference(ctx.scene, ctx.device, torch.bfloat16)
        for seed in args.control_seeds:
            t0 = time.perf_counter()
            ctx.seed = seed
            values = check.numbers(control_output(ctx, ref_low), ctx, ref)
            emit("control_bf16", seed, values, time.perf_counter() - t0)
        del ref_low
    if args.faults:
        for name in faults.FAULTS:
            for seed in args.control_seeds:
                t0 = time.perf_counter()
                values = check.numbers(program(seed, name), ctx, ref)
                emit(f"fault_{name}", seed, values, time.perf_counter() - t0)
    guard.check("end")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
