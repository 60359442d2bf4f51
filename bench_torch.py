"""Benchmark of spray_tpu_torch: prints ONE JSON line with the headline metric.

    python bench_torch.py                 # the bench configuration on the card
    python bench_torch.py --device cpu --blobs 2 --tris-per-blob 80 --size 16

The counterpart of bench.py's headline: forward+backward throughput in
Grays/s of `make_pipeline(backward=True)` on wisp_cloud(8, 131072, seed=3)
(2,621,442 tris) at 512x512, spp 4, bounces 2, PT+NEE, seed 0.  The
numerator is the rays actually traced (lanes with a live window in each
intersect / occluded call), the denominator the least of --iters step
times, each step fenced with torch.cuda.synchronize().  The line has
bench.py's keys; detail.card is the card's name and power limit from
nvidia-smi.  --device cuda (the default) needs the card and never falls
back to the CPU.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

TARGET_GRAYS = 2.0  # north-star target of BASELINE.md; vs_baseline = value / it


def card_name(device):
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def headline(args):
    import torch

    from spray_tpu_torch.core.camera import make_camera
    from spray_tpu_torch.core.config import RenderConfig
    from spray_tpu_torch.core.device import resolve_device
    from spray_tpu_torch.io.scenes import wisp_cloud
    from spray_tpu_torch.render import default_intersector, make_pipeline

    device = resolve_device(args.device)

    def fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    scene = wisp_cloud(n_blobs=args.blobs, tris_per_blob=args.tris_per_blob,
                       seed=3)
    camera = make_camera(eye=(14.0, 10.0, 18.0), lookat=(0, 0, 0), up=(0, 1, 0),
                         fov_y_deg=45, width=args.size, height=args.size)
    cfg = RenderConfig(spp=args.spp, bounces=args.bounces, integrator="pt",
                       seed=0)
    t0 = time.perf_counter()
    isect = default_intersector(scene, prefer=args.intersector, device=device)
    fence()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe = make_pipeline(scene, camera, cfg, backward=args.backward,
                         intersector=isect, device=device)
    fence()
    transfer_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe.run()  # kernel load and warm-up
    fence()
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(args.iters):
        fence()
        t0 = time.perf_counter()
        out = pipe.run()
        fence()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    rays = pipe.rays_traced(out)
    grays = rays / dt / 1e9
    return {
        "metric": "grays_per_sec_fwd_bwd" if args.backward else "grays_per_sec_fwd",
        "value": grays,
        "unit": "Grays/s/chip",
        "vs_baseline": grays / TARGET_GRAYS,
        "detail": {
            "tris": int(scene.num_faces),
            "size": args.size,
            "spp": args.spp,
            "bounces": args.bounces,
            "rays_per_frame": rays,
            "frame_s": dt,
            "frame_times_s": times,
            "compile_s": compile_s,
            "transfer_s": transfer_s,
            "build_s": build_s,
            "backend": device.type,
            "intersector": type(isect).__name__,
            "card": card_name(device),
            "notes": (
                "spray_tpu_torch on torch " + torch.__version__ + ": frame_s "
                "is the least of --iters steps, each fenced with "
                "torch.cuda.synchronize(); compile_s is the first step "
                "(kernel load and warm-up); transfer_s is make_pipeline (the "
                "scene's parameter and shading arrays uploaded); build_s is "
                "the intersector (host page build and its upload); "
                "vs_baseline = value / 2.0, the north-star target"
            ),
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--bounces", type=int, default=2)
    ap.add_argument("--blobs", type=int, default=8)
    ap.add_argument("--tris-per-blob", type=int, default=131072)
    ap.add_argument("--backward", action="store_true", default=True)
    ap.add_argument("--no-backward", dest="backward", action="store_false")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--intersector", default="auto",
                    help="auto|sweep|binned|multidomain|brute")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    args = ap.parse_args(argv)
    print(json.dumps(headline(args)), flush=True)


if __name__ == "__main__":
    main()
