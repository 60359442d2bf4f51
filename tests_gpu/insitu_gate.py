"""Gate of the in-situ collective renderer of spray_tpu_torch.

    python tests_gpu/insitu_gate.py               # on the card, one NCCL rank
    python tests_gpu/insitu_gate.py --device cpu  # the kernels' plain versions

The counterpart of tests_tpu/insitu_gate.py, on its scene
(wisp_cloud(8, 16384, seed=3), 131,074 tris), 128x128, spp 1, bounces 2:
the collective in-situ path (`make_insitu_renderer`, 8 domains, bucket
16,384, the cluster kernels as its local trace, its all_to_all router and
epoch loop) runs in a world of one rank started by run_world, and must stay
within 3x of the fast path on the same scene (`MultiDomainClusterIntersector`
with 8 domains through make_render_fn) and agree with it within 1e-4.  Each
side is the least of 2 frames after a warm-up, each ended on the host.
Prints one INSITU_GATE JSON line with the reference's keys and the card's
name and power limit.

Then the router's check (`route_check`, in another world of one rank): the
send layout of `kernels.route.route_slots` (`route_slots_kernel` on the
card) equals its plain version byte for byte at the in-situ cell's shape
(262,144 rays, 4 owners, bucket 65,536) and at an overflowing bucket, all
rays to one owner, ragged ray counts, one owner and the most owners the
kernel takes; on the card, the kernel's device time (both of its launches,
by the profiler), its bound by bytes, the plain version's time and, as
`library_ms`, the time of the one-hot `torch.cumsum(..., dim=0)` the plain
version does at the cell's shape; and after one in-situ frame of the gate's
configuration the kernel's launches equal the frame's rounds (no launch on
the CPU).  Prints one ROUTE_CHECK JSON line.  Exits 0 when both pass, else
1.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch

from bench_torch import card_name
from spray_tpu_torch.core.camera import make_camera
from spray_tpu_torch.core.config import RenderConfig
from spray_tpu_torch.core.device import resolve_device
from spray_tpu_torch.io.scenes import wisp_cloud

HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
MAX_DIFF = 1e-4  # same commits and samples; only the min-combine order differs
MAX_RATIO = 3.0  # the regression alarm of the reference's gate, not a target
N_DOMAINS = 8
BUCKET = 1 << 14
TIMED = 2  # timed frames of each side, after a warm-up


def best_frame(fn, device):
    """(the last image, the least seconds of TIMED calls after a warm-up)."""
    img = fn()
    best = float("inf")
    for _ in range(TIMED):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        img = fn()  # numpy: the frame is back on the host
        best = min(best, time.perf_counter() - t0)
    return img, best


def gate_rank(rank, world_size, scene, camera, cfg, device_type):
    """The gate in one rank of a world: the in-situ frame against the fast
    path's, on this rank's device.  Returns the gate's numbers."""
    import numpy as np

    from spray_tpu_torch.dist.epochs import make_insitu_renderer
    from spray_tpu_torch.dist.rayshard import make_mesh
    from spray_tpu_torch.integrators.device import make_render_fn
    from spray_tpu_torch.integrators.wavefront import make_scene_arrays
    from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector

    mesh = make_mesh(world_size, device=device_type)
    dev = mesh.device
    render = make_insitu_renderer(scene, camera, cfg, mesh, n_domains=N_DOMAINS,
                                  bucket=BUCKET, backend="cluster")
    img, insitu_s = best_frame(render, dev)
    isect = MultiDomainClusterIntersector(scene, n_domains=N_DOMAINS, device=dev)
    arrays = make_scene_arrays(scene, dev)
    fn = make_render_fn(scene, camera, cfg, isect, device=dev)
    ref, direct_s = best_frame(lambda: fn(arrays).cpu().numpy(), dev)
    diff = float(np.abs(img - ref).max())
    ratio = insitu_s / direct_s
    return {"ok": bool(diff <= MAX_DIFF and ratio <= MAX_RATIO),
            "insitu_s": insitu_s, "direct_s": direct_s, "ratio": ratio,
            "max_img_diff": diff, "epochs": render.last_stats["epochs"],
            "exchanged": render.last_stats["rays_exchanged"]}


def gate(scene, camera, cfg, device=None):
    """Run the gate in a world of one rank on `device` (None: the card,
    NCCL; "cpu": gloo).  Returns its numbers (`gate_rank`)."""
    from spray_tpu_torch.dist.launch import run_world

    device = resolve_device(device)
    return run_world(gate_rank, 1, scene, camera, cfg, device.type,
                     device=device)[0]


# name: (rays m, owners ndev, bucket, owners drawn); "uniform" draws each
# ray's owner from [0, ndev], ndev being "no destination"
ROUTE_CASES = {
    "cell": (262144, 4, 65536, "uniform"),
    "overflow": (262144, 4, 4096, "uniform"),
    "one_owner": (262144, 4, 65536, "one_owner"),
    "ragged": (300001, 4, 65536, "uniform"),
    "ragged_small": (1025, 2, 7, "uniform"),
    "ndev1": (262144, 1, BUCKET, "uniform"),
    "ndev64": (262144, 64, 4096, "uniform"),
}
ROUTE_TIMED = 50  # calls of the kernel timed at the cell's shape
PLAIN_TIMED = 5  # calls of the plain version and of the cumsum


def _route_dest(kind, m, ndev, device, seed=0):
    import numpy as np

    rs = np.random.RandomState(seed)
    dest = (rs.randint(0, ndev + 1, m) if kind == "uniform"
            else np.full(m, ndev - 1))
    return torch.as_tensor(dest.astype(np.int64), device=device)


def _events_ms(fn, n, device):
    """Mean ms of n calls of fn between two CUDA events, after a warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / n


def _kernel_ms(fn, n, device, names):
    """Device ms a call of the kernels whose names hold one of `names`, by
    the profiler's device events over n calls (None if it saw none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize(device)
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and any(k in e.name for k in names))
    return us / 1e3 / n if us > 0 else None


def route_rank(rank, world_size, scene, camera, cfg, device_type):
    """The router's check in one rank of a world (see the module's head).
    Returns its numbers."""
    from spray_tpu_torch.dist.epochs import make_insitu_renderer
    from spray_tpu_torch.dist.rayshard import make_mesh
    from spray_tpu_torch.kernels import route

    mesh = make_mesh(world_size, device=device_type)
    dev = mesh.device
    cuda = dev.type == "cuda"
    cases = {}
    for name, (m, ndev, bucket, kind) in ROUTE_CASES.items():
        dest = _route_dest(kind, m, ndev, dev)
        got = route.route_slots(dest, ndev, bucket)
        want = route.route_slots_reference(dest, ndev, bucket)
        cases[name] = bool(torch.equal(got, want))
    out = {"cases": cases, "kernel_ms": None, "call_ms": None,
           "bound_ms": None, "plain_ms": None, "library_ms": None}
    if cuda:
        m, ndev, bucket, kind = ROUTE_CASES["cell"]
        dest = _route_dest(kind, m, ndev, dev)
        onehot = (dest[:, None] == torch.arange(ndev, device=dev)[None]
                  ).to(torch.int32)
        out["kernel_ms"] = _kernel_ms(
            lambda: route.route_slots(dest, ndev, bucket), ROUTE_TIMED, dev,
            ("route_count_kernel", "route_slots_kernel"))
        out["call_ms"] = _events_ms(
            lambda: route.route_slots(dest, ndev, bucket), ROUTE_TIMED, dev)
        out["bound_ms"] = (8 * m + 8 * ndev * bucket) / HBM_BYTES_S * 1e3
        out["plain_ms"] = _events_ms(
            lambda: route.route_slots_reference(dest, ndev, bucket),
            PLAIN_TIMED, dev)
        out["library_ms"] = _events_ms(lambda: torch.cumsum(onehot, dim=0),
                                       PLAIN_TIMED, dev)
    render = make_insitu_renderer(scene, camera, cfg, mesh, n_domains=N_DOMAINS,
                                  bucket=BUCKET, backend="cluster")
    render()  # builds and warms the kernels
    route.reset_launches()
    render()
    out["frame_launches"] = route.launches["route_slots_kernel"]
    out["frame_rounds"] = render.last_stats["epochs"]
    want = out["frame_rounds"] if cuda else 0
    out["ok"] = bool(all(cases.values()) and out["frame_rounds"] > 0
                     and out["frame_launches"] == want)
    return out


def route_check(scene, camera, cfg, device=None):
    """Run the router's check in a world of one rank on `device` (None: the
    card, NCCL; "cpu": gloo, the plain version).  Returns its numbers
    (`route_rank`)."""
    from spray_tpu_torch.dist.launch import run_world

    device = resolve_device(device)
    return run_world(route_rank, 1, scene, camera, cfg, device.type,
                     device=device)[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    device = resolve_device(ap.parse_args(argv).device)
    scene = wisp_cloud(n_blobs=8, tris_per_blob=16384, seed=3)
    camera = make_camera(eye=(14.0, 10.0, 18.0), lookat=(0, 0, 0), up=(0, 1, 0),
                         fov_y_deg=45, width=128, height=128)
    cfg = RenderConfig(spp=1, bounces=2, integrator="pt", seed=0)
    res = gate(scene, camera, cfg, device)
    res["card"] = card_name(device)
    print("INSITU_GATE " + json.dumps(res), flush=True)
    routed = route_check(scene, camera, cfg, device)
    routed["card"] = res["card"]
    print("ROUTE_CHECK " + json.dumps(routed), flush=True)
    return 0 if res["ok"] and routed["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
