"""Benchmark of spray_tpu_torch: prints ONE JSON line with the headline metric.

    python bench_torch.py                 # the bench configuration on the card
    python bench_torch.py --suite         # and the scheduler suite and the curve
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

--suite then measures the speculative epoch scheduler itself, as bench.py's
spec_suite does (configs 3 and 4 of BASELINE.md: 8 domains in 8 slots with
speculation unbounded, bounded to 3 and off; 64 domains through 8 slots
with prefetch lookahead on and off), and the weak-scaling curve of the two
distributed paths (spray_tpu_torch.dist.scaling, its own process), and
writes both to build/BENCH_extra_torch.json with the card's name, the
kernels' launches per frame of each row and the seconds each part took
(suite_s, curve_s).  The headline line is printed first; stdout stays that
one line.  A failing suite or curve exits non-zero with its traceback.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

TARGET_GRAYS = 2.0  # north-star target of BASELINE.md; vs_baseline = value / it
SUITE_PATH = ROOT / "build" / "BENCH_extra_torch.json"
SUITE_TIMED = 3  # timed renders of each suite variant, after one warm-up
# bench.py's spec_suite variants: (row, domains, slots, OOCIntersector options)
SUITE_VARIANTS = (
    ("config3_speculative", 8, 8, dict(speculate=True, lookahead=False)),
    ("config3_bounded3", 8, 8, dict(speculate=3, lookahead=False)),
    ("config3_baseline", 8, 8, dict(speculate=False, lookahead=False)),
    ("config4_prefetch", 64, 8, dict(speculate=True, lookahead=True)),
    ("config4_noprefetch", 64, 8, dict(speculate=True, lookahead=False)),
)
# the keys of bench.py's rows, by config; two name suite_row's counters
# otherwise (RENAMED)
ROW_KEYS = {
    "config3": ("frame_s", "warm_s", "epochs", "ray_domain_activations",
                "speculated", "committed", "speculation_efficiency",
                "grays_per_sec"),
    "config4": ("frame_s", "warm_s", "epochs", "domain_loads", "cache_hits",
                "prefetches", "speculation_efficiency", "lookahead_active",
                "host_to_hbm_mbps"),
}
RENAMED = {"ray_domain_activations": "rays_traced",
           "speculated": "rays_speculated"}

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


def scheduler(scene, device, **kw):
    """OOCIntersector on `device`; on the card it must be the cluster
    backend (the CUDA kernels), which "auto" picks there."""
    from spray_tpu_torch.sched.epochs import OOCIntersector

    oc = OOCIntersector(scene, device=device, **kw)
    if device.type == "cuda" and oc.backend != "cluster":
        raise RuntimeError(f"the suite runs the cluster backend on the card, "
                           f"got {oc.backend!r}")
    return oc


def suite_row(scene, camera, cfg, n_domains, num_slots, device,
              timed=SUITE_TIMED, **kw):
    """One variant of the scheduler suite, as bench.py's spec_suite runs it:
    an OOCIntersector(n_domains, num_slots, **kw), one warm-up render, its
    counters and residency counters reset, then `timed` renders, each
    started after torch.cuda.synchronize() and ended on the host (the image
    comes back as numpy).  Returns (row, the last image, the intersector):
    row holds each EpochStats counter per frame (the sum over the timed
    renders // timed, as the reference divides), launches (the traversal
    kernels' launches per timed frame, 0 on the CPU), frame_s (the least
    time), frame_times_s, warm_s, speculation_efficiency (committed /
    traced over the timed renders), grays_per_sec (activations per frame /
    frame_s), lookahead_active and host_to_hbm_mbps (the lookahead
    probe)."""
    import dataclasses

    import torch

    from spray_tpu_torch.integrators.device import render_device
    from spray_tpu_torch.kernels import traverse
    from spray_tpu_torch.sched.epochs import EpochStats

    def fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    oc = scheduler(scene, device, n_domains=n_domains, num_slots=num_slots, **kw)
    fence()
    t0 = time.perf_counter()
    render_device(scene, camera, cfg, intersector=oc, device=device)
    warm = time.perf_counter() - t0
    oc.stats = EpochStats()
    oc.residency.hits = oc.residency.loads = oc.residency.prefetches = 0
    before = dict(traverse.launches)
    times = []
    for _ in range(timed):
        fence()
        t0 = time.perf_counter()
        img = render_device(scene, camera, cfg, intersector=oc, device=device)
        times.append(time.perf_counter() - t0)
    s = oc.stats
    row = {f.name: getattr(s, f.name) // timed
           for f in dataclasses.fields(EpochStats)}
    row.update(launches={k: (v - before[k]) // timed
                         for k, v in traverse.launches.items()},
               frame_s=min(times), frame_times_s=times, warm_s=warm,
               speculation_efficiency=s.speculation_efficiency,
               grays_per_sec=row["rays_traced"] / min(times) / 1e9,
               lookahead_active=bool(oc.lookahead),
               host_to_hbm_mbps=oc.host_to_hbm_mbps)
    return row, img, oc


def spec_suite(args, device):
    """Configs 3 and 4: the speculative epoch scheduler measured as a
    scheduler, at bench.py's spec_suite configuration: a max(64, size // 4)
    square frame of wisp_cloud(8, tris_per_blob // 8, seed=3) (163,842 tris
    at the defaults), spp 1, bounces 2, PT, the headline's camera.  Returns
    {row name: row with bench.py's keys, "launches": {row name: the
    traversal kernels' launches per frame}}."""
    from spray_tpu_torch.core.camera import make_camera
    from spray_tpu_torch.core.config import RenderConfig
    from spray_tpu_torch.integrators.device import render_device
    from spray_tpu_torch.io.scenes import wisp_cloud

    size = max(64, args.size // 4)
    scene = wisp_cloud(n_blobs=8, tris_per_blob=args.tris_per_blob // 8, seed=3)
    camera = make_camera(eye=(14.0, 10.0, 18.0), lookat=(0, 0, 0), up=(0, 1, 0),
                         fov_y_deg=45, width=size, height=size)
    cfg = RenderConfig(spp=1, bounces=2, integrator="pt", seed=0)
    # one render first, so that no variant's warm_s holds the kernels' load
    prime = scheduler(scene, device, n_domains=8, num_slots=8, speculate=True,
                      lookahead=False)
    render_device(scene, camera, cfg, intersector=prime, device=device)
    out = {"launches": {}}
    for name, n_domains, num_slots, kw in SUITE_VARIANTS:
        row, _, _ = suite_row(scene, camera, cfg, n_domains, num_slots, device,
                              **kw)
        out[name] = {k: row[RENAMED.get(k, k)]
                     for k in ROW_KEYS[name.split("_")[0]]}
        out["launches"][name] = row["launches"]
    return out


def scaling_suite():
    """The weak-scaling curve in gloo CPU ranks (--device cpu, as bench.py
    runs profiling/scaling_curve.py with JAX_PLATFORMS=cpu), as its own
    process: its ranks start from a process that holds no CUDA context.
    Its progress lines pass through to stderr."""
    out = subprocess.run(
        [sys.executable, "-m", "spray_tpu_torch.dist.scaling", "--device",
         "cpu"], cwd=ROOT,
        stdout=subprocess.PIPE, text=True, timeout=1800, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


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
    ap.add_argument("--suite", action="store_true",
                    help="also run the scheduler suite -> build/BENCH_extra_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    args = ap.parse_args(argv)
    result = headline(args)
    if args.suite:
        result["detail"]["suite"] = os.path.relpath(SUITE_PATH, ROOT)
    print(json.dumps(result), flush=True)
    if args.suite:
        from spray_tpu_torch.core.device import resolve_device

        device = resolve_device(args.device)
        t0 = time.perf_counter()
        extra = spec_suite(args, device)
        t1 = time.perf_counter()
        extra["scaling_cpu_mesh"] = scaling_suite()
        extra.update(card=card_name(device), suite_s=t1 - t0,
                     curve_s=time.perf_counter() - t1)
        SUITE_PATH.parent.mkdir(parents=True, exist_ok=True)
        SUITE_PATH.write_text(json.dumps(extra, indent=1))


if __name__ == "__main__":
    main()
