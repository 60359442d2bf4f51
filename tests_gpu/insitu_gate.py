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
name and power limit; exits 0 when the gate passes, else 1.
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
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
