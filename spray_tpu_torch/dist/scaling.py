"""Weak-scaling curve of the two distributed paths in gloo CPU ranks
(counterpart of ``profiling/scaling_curve.py``).

    python -m spray_tpu_torch.dist.scaling                # NCCL ranks, a card each
    python -m spray_tpu_torch.dist.scaling --device cpu   # gloo CPU ranks

Work scales with the world: the image is 64 wide and 32 * n high at n
ranks, so each rank's share of the rays stays the same.  The baseline at
every world size is the same work run as n independent per-rank renders
(each rank its own tile of pixels against the whole scene, no collective,
all ranks at once), traced with the same machinery as the path it is held
against: the cluster intersector (`MultiDomainClusterIntersector`,
routed=False) for the in-situ frame, the batched-torch BVH walk for the
ray-sharded step.  efficiency = t_independent / t_distributed is the share
of embarrassingly parallel throughput that survives the distribution
(all_to_all routing, liveness all_reduce and bucket padding for in-situ;
the gradient all_reduce for the ray-sharded step).  `insitu_eff` and
`rayshard_eff` are capped at 1, the `_raw` keys are not.

--device cuda (the default, as `curve(device=None)`) runs NCCL ranks, one
card each, and stops at the first world larger than the cards; --device cpu
runs each world as `run_world(..., device="cpu")`: one process and one CPU
thread a rank, gloo between them, as the reference's bench.py runs a CPU
mesh, and stops at the first world larger than os.cpu_count().  Prints one
JSON object {"1": {...}, "2": {...}, ...}, each row with the reference's
keys; every time is the least of TIMED calls after a warm-up, and a world's
time is its slowest rank's.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from ..core.camera import make_camera
from ..core.config import RenderConfig
from ..core.device import resolve_device
from ..io.scenes import wisp_cloud

SCENE = dict(n_blobs=4, tris_per_blob=1024, seed=5)  # 5,122 tris
CFG = RenderConfig(spp=1, bounces=1, integrator="pt", seed=0)
WORLD_SIZES = (1, 2, 4, 8)
TIMED = 5  # timed calls of each path, after a warm-up
N_DOMAINS = 8


def camera_of(world_size):
    """The curve's camera: 32 rows a rank."""
    return make_camera(eye=(10.0, 8.0, 14.0), lookat=(0, 0, 0), up=(0, 1, 0),
                       fov_y_deg=45, width=64, height=32 * world_size)


def _rank_device(device_type):
    """This rank's device: its current card, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def best_time(fn, iters, device):
    """Least seconds of fn() over `iters` calls after a warm-up, every rank
    starting each call together, each call ended by the card's work."""
    def fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    ts = []
    for _ in range(iters):
        fence()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        fn()
        fence()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _tile(camera, rank, world_size, device):
    """This rank's contiguous tile of the padded pixel ids, and npix."""
    from .rayshard import padded_pixel_ids  # noqa: PLC0415

    ids, npix = padded_pixel_ids(camera, world_size)
    per = len(ids) // world_size
    mine = ids[rank * per:(rank + 1) * per].astype(np.int64)
    return torch.as_tensor(mine, device=device), npix


def insitu_times(rank, world_size, scene_kw=SCENE, iters=TIMED,
                 device_type="cpu"):
    """(t_independent, t_distributed) of this rank for the in-situ frame.
    Independent: one sample of the rank's tile through the 8-domain cluster
    intersector, no collective; distributed: make_insitu_renderer's frame
    (8 domains, one bucket holding a rank's rays, 32 epochs at most)."""
    from ..integrators import wavefront  # noqa: PLC0415
    from ..kernels.multidomain import MultiDomainClusterIntersector  # noqa: PLC0415
    from .epochs import make_insitu_renderer  # noqa: PLC0415

    dev = _rank_device(device_type)
    scene = wisp_cloud(**scene_kw)
    cam = camera_of(world_size)
    isect = MultiDomainClusterIntersector(scene, n_domains=N_DOMAINS,
                                          routed=False, device=dev)
    arrays = wavefront.make_scene_arrays(scene, dev)
    pix, npix = _tile(cam, rank, world_size, dev)

    def tile():
        return torch.sum(wavefront.sample_wavefront(arrays, cam, CFG, isect, 0,
                                                    pix))

    render = make_insitu_renderer(scene, cam, CFG, n_domains=N_DOMAINS,
                                  bucket=max(128, npix // world_size),
                                  max_epochs=32, device=dev)
    return best_time(tile, iters, dev), best_time(render, iters, dev)


def rayshard_times(rank, world_size, scene_kw=SCENE, iters=TIMED,
                   device_type="cpu"):
    """(t_independent, t_distributed) of this rank for the ray-sharded
    gradient step.  Independent: the step's own work on this rank's tile
    alone (render, loss and the vertex and albedo gradients through the
    same detached BVH intersector), no collective; distributed: the same
    tile through make_sharded_render_grad, the gradients all-reduced."""
    from ..bvh.traverse import BVHIntersector  # noqa: PLC0415
    from ..diff import (  # noqa: PLC0415
        DetachedIntersector, diff_scene_arrays, grads_of, scene_consts,
    )
    from ..integrators import wavefront  # noqa: PLC0415
    from .rayshard import make_sharded_render_grad, padded_pixel_ids  # noqa: PLC0415

    dev = _rank_device(device_type)
    scene = wisp_cloud(**scene_kw)
    cam = camera_of(world_size)
    isect = BVHIntersector(scene, device=dev)
    consts = scene_consts(scene, dev)
    pix, npix = _tile(cam, rank, world_size, dev)
    params = {k: torch.as_tensor(np.asarray(getattr(scene, k), np.float32),
                                 device=dev) for k in ("vertices", "albedo")}
    w = torch.tensor([0.4, 0.8, 1.3], device=dev)

    def tile_grad():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        arrays, vertices, faces = diff_scene_arrays(scene, p, consts)
        rad = wavefront.sample_wavefront(
            arrays, cam, CFG, DetachedIntersector(isect, vertices, faces), 0,
            pix)
        loss = torch.sum(rad * w) / float(npix * 3)
        return loss.detach(), grads_of(loss, p)

    step = make_sharded_render_grad(scene, cam, CFG,
                                    make_intersector=lambda s: isect, device=dev)
    ids, _ = padded_pixel_ids(cam, world_size)
    return (best_time(tile_grad, iters, dev),
            best_time(lambda: step(params, ids), iters, dev))


def curve_rank(rank, world_size, scene_kw, iters, device_type):
    """Both paths' times in one rank of the world."""
    ind, ins = insitu_times(rank, world_size, scene_kw, iters, device_type)
    indg, ray = rayshard_times(rank, world_size, scene_kw, iters, device_type)
    return {"indep_frame_s": ind, "insitu_frame_s": ins,
            "indep_grad_s": indg, "rayshard_step_s": ray}


def curve(world_sizes=WORLD_SIZES, scene_kw=SCENE, iters=TIMED, device=None):
    """{str(n): row} for each world size n, in order, up to the first that
    the machine cannot hold: more ranks than CPUs (device "cpu") or than
    cards (None, the card)."""
    from .launch import run_world  # noqa: PLC0415

    device = resolve_device(device)
    most = (torch.cuda.device_count() if device.type == "cuda"
            else os.cpu_count())
    out = {}
    for n in world_sizes:
        if n > most:
            break
        t0 = time.perf_counter()
        ranks = run_world(curve_rank, n, scene_kw, iters, device.type,
                          device=device)
        t = {k: max(r[k] for r in ranks) for k in ranks[0]}
        row = {"indep_frame_s": t["indep_frame_s"],
               "insitu_frame_s": t["insitu_frame_s"]}
        eff = t["indep_frame_s"] / t["insitu_frame_s"]
        row.update(insitu_eff=min(eff, 1.0), insitu_eff_raw=eff,
                   indep_grad_s=t["indep_grad_s"],
                   rayshard_step_s=t["rayshard_step_s"])
        eff = t["indep_grad_s"] / t["rayshard_step_s"]
        row.update(rayshard_eff=min(eff, 1.0), rayshard_eff_raw=eff)
        if not all(math.isfinite(v) and v > 0 for v in row.values()):
            raise ValueError(f"world {n}: a time or efficiency is not positive "
                             f"and finite: {row}")
        out[str(n)] = row
        print(f"# world {n}: {time.perf_counter() - t0:.1f} s, {row}",
              file=sys.stderr, flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL ranks, a card each) or cpu (gloo ranks)")
    args = ap.parse_args(argv)
    print(json.dumps(curve(device=args.device)), flush=True)


if __name__ == "__main__":
    main()
