"""Command-line renderer (counterpart of ``spray_tpu/cli.py``).

    python -m spray_tpu_torch.cli render  --scene scene.json -o out.png [options]
    python -m spray_tpu_torch.cli render  --builtin cornell  -o out.png
    python -m spray_tpu_torch.cli bench   --size 512 --spp 4 --bounces 2
    python -m spray_tpu_torch.cli inspect --scene scene.json

Modes mirror the reference's app matrix:
  --scheduler one-shot   all domains resident, dense speculative trace
               ooc       epoch loop with bounded residency slots
               baseline  non-speculative front-to-back (the correctness and
                         performance comparison apps)
`--device` (default cuda) is where render and bench run; the CLI never
falls back to the CPU: without a card, pass --device cpu.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parents[1] / "bench_torch.py"


def _build_scene(args):
    from .io import scenes as S

    if args.scene:
        from .io.scene_file import load_scene

        scene, assign, camera = load_scene(args.scene)
        return scene, camera
    name = args.builtin
    if name == "cornell":
        return S.cornell_box(), None
    if name == "sphere":
        return S.bumpy_sphere(subdiv=6), None
    if name == "wisp":
        per_blob = max(80, args.tris // args.blobs)
        return S.wisp_cloud(n_blobs=args.blobs, tris_per_blob=per_blob), None
    raise SystemExit(f"unknown builtin scene {name!r}")


def _default_camera(scene, args):
    v = np.asarray(scene.vertices)
    c = (v.min(0) + v.max(0)) / 2
    r = float(np.linalg.norm(v.max(0) - v.min(0))) / 2
    eye = c + np.asarray([0.9, 0.65, 1.2]) * (2.2 * r)
    from .core.camera import make_camera

    return make_camera(
        eye=eye, lookat=c, up=(0, 1, 0), fov_y_deg=40,
        width=args.size, height=args.size,
    )


def _make_intersector(scene, args, device):
    """one-shot: the default intersector; ooc and baseline: the epoch
    scheduler, whose "auto" backend is the cluster pages on the card."""
    from .render import default_intersector

    if args.scheduler == "one-shot":
        return default_intersector(scene, device=device)
    from .sched.epochs import OOCIntersector

    return OOCIntersector(
        scene, n_domains=args.domains, num_slots=args.slots,
        speculate=(args.scheduler != "baseline"), leaf_size=8, device=device,
    )


def cmd_render(args):
    from .core.config import RenderConfig
    from .core.device import resolve_device
    from .core.image import write_image
    from .integrators.device import render_device

    device = resolve_device(args.device)
    scene, camera = _build_scene(args)
    if camera is None or args.size != camera.width:
        camera = _default_camera(scene, args)
    cfg = RenderConfig(
        width=camera.width, height=camera.height, spp=args.spp,
        bounces=args.bounces, ao_samples=args.ao_samples,
        integrator=args.integrator, seed=args.seed,
        background=tuple(args.background),
    )
    inter = _make_intersector(scene, args, device)
    t0 = time.time()
    img = render_device(scene, camera, cfg, intersector=inter, device=device)
    dt = time.time() - t0
    write_image(args.output, img)
    stats = {
        "scene_tris": int(scene.num_faces),
        "resolution": [camera.width, camera.height],
        "spp": cfg.spp,
        "integrator": cfg.integrator,
        "scheduler": args.scheduler,
        "wall_s": round(dt, 3),
        "backend": device.type,
        "output": args.output,
    }
    if hasattr(inter, "stats"):  # epoch scheduler counters (R19)
        s = inter.stats
        stats["epochs"] = s.epochs
        stats["rays_traced"] = s.rays_traced
        stats["rays_speculated"] = s.rays_speculated
        stats["domain_loads"] = s.domain_loads
        stats["residency_hits"] = s.cache_hits
        stats["speculation_efficiency"] = round(s.speculation_efficiency, 4)
    if args.epoch_log and getattr(inter, "epoch_log", None):
        with open(args.epoch_log, "w") as f:
            for row in inter.epoch_log:
                f.write(json.dumps(row) + "\n")
        stats["epoch_log"] = args.epoch_log
    print(json.dumps(stats))
    if args.view:
        from .viewer import show_terminal

        show_terminal(img)


def cmd_bench(args):
    import subprocess

    cmd = [sys.executable, str(BENCH), "--size", str(args.size),
           "--spp", str(args.spp), "--bounces", str(args.bounces),
           "--device", args.device]
    raise SystemExit(subprocess.call(cmd))


def cmd_inspect(args):
    scene, camera = _build_scene(args)
    v = np.asarray(scene.vertices)
    em = np.asarray(scene.emission)
    info = {
        "vertices": int(len(v)),
        "triangles": int(scene.num_faces),
        "emissive_faces": int((em.max(1) > 0).sum()),
        "aabb": [v.min(0).tolist(), v.max(0).tolist()],
    }
    print(json.dumps(info, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="spray_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_scene_args(p):
        p.add_argument("--scene", help="scene description JSON")
        p.add_argument("--builtin", default="cornell",
                       choices=["cornell", "sphere", "wisp"])
        p.add_argument("--tris", type=int, default=1 << 20)
        p.add_argument("--blobs", type=int, default=8)

    pr = sub.add_parser("render")
    add_scene_args(pr)
    pr.add_argument("-o", "--output", default="out.png")
    pr.add_argument("--size", type=int, default=512)
    pr.add_argument("--spp", type=int, default=16)
    pr.add_argument("--bounces", type=int, default=3)
    pr.add_argument("--ao-samples", type=int, default=8)
    pr.add_argument("--integrator", default="pt", choices=["pt", "ao", "normal"])
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--background", type=float, nargs=3,
                    default=[0.0, 0.0, 0.0])
    pr.add_argument("--scheduler", default="one-shot",
                    choices=["one-shot", "ooc", "baseline"])
    pr.add_argument("--domains", type=int, default=16)
    pr.add_argument("--slots", type=int, default=4)
    pr.add_argument("--view", action="store_true",
                    help="ANSI terminal preview after render")
    pr.add_argument("--epoch-log", default=None, metavar="PATH",
                    help="write per-epoch scheduler log as JSONL (ooc/"
                         "baseline schedulers)")
    pr.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda or cpu)")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("bench")
    pb.add_argument("--size", type=int, default=512)
    pb.add_argument("--spp", type=int, default=4)
    pb.add_argument("--bounces", type=int, default=2)
    pb.add_argument("--device", default="cuda",
                    help="torch device to run bench_torch.py on")
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("inspect")
    add_scene_args(pi)
    pi.set_defaults(fn=cmd_inspect)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
