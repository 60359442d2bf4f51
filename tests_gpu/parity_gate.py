"""Parity gate of the CUDA kernels of spray_tpu_torch against the brute oracle.

    python tests_gpu/parity_gate.py               # on the card
    python tests_gpu/parity_gate.py --device cpu  # the kernels' plain versions

The counterpart of tests_tpu/parity_gate.py, on the same scene
(wisp_cloud(2, 8192, seed=3), 40,962 tris), the same 128x128 camera and the
same ray sets: the camera rays of a frame (tile-swizzle order, sample 0)
and 16,384 incoherent rays (random origins in the scene box, random
directions, RandomState(7)).  MultiDomainClusterIntersector(n_domains=4)
(nearest_kernel, anyhit_kernel) and ClusterBVHIntersector
(nearest_slot_kernel, anyhit_kernel on one-entry lists) are held against
the torch brute-force intersector: nearest hits (valid masks, t and
non-tie prims, tie-tolerant as in spray_tpu_torch.parity) and occlusion
on a window of 1.5 t (20 where the ray misses), each below 1e-5, the
reference's measured zeros.  Then frames: the 128x128 PT+NEE frame
through the two intersectors, and a 64x64 frame through the multi-domain
intersector against render_oracle, each with fewer than 1e-5 of the
pixels off by more than 1e-3.  Prints one PARITY_GATE JSON line; exits 0
when the gate passes, else 1.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from spray_tpu_torch.core import geom, rng
from spray_tpu_torch.core.camera import make_camera
from spray_tpu_torch.core.config import RenderConfig
from spray_tpu_torch.core.device import resolve_device
from spray_tpu_torch.integrators.device import render_device
from spray_tpu_torch.io.scenes import wisp_cloud
from spray_tpu_torch.kernels.common import tile_swizzle_order
from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector
from spray_tpu_torch.kernels.traverse import ClusterBVHIntersector
from spray_tpu_torch.oracle import render_oracle
from spray_tpu_torch.oracle.brute import BruteIntersector
from spray_tpu_torch.parity import hit_mismatch

BOUND = 1e-5  # the reference gate's bound: no mismatching ray of 16,384
TOL = (1e-3, 0.0, 1e-3)  # t and tie tolerance: 1e-3 of max(|t|, 1e-3)


def camera_of(size):
    return make_camera(eye=(14.0, 10.0, 18.0), lookat=(0, 0, 0), up=(0, 1, 0),
                       fov_y_deg=45, width=size, height=size)


def ray_sets(scene, camera, n, device):
    """(name, o, d, tmin, tmax) ray populations with real-frame statistics."""
    pixel_ids = torch.as_tensor(
        tile_swizzle_order(camera.width, camera.height).astype(np.int64),
        device=device)
    jx = rng.uniform(0, pixel_ids, 0, rng.dim_id(0, rng.PIXEL_JITTER, 0))
    jy = rng.uniform(0, pixel_ids, 0, rng.dim_id(0, rng.PIXEL_JITTER, 1))
    o, d = geom.camera_rays(camera, pixel_ids, jx, jy)
    tmin = torch.zeros(n, dtype=torch.float32, device=device)
    tmax = torch.full((n,), float(geom.INF), dtype=torch.float32, device=device)
    yield "camera", o, d, tmin, tmax

    v = np.asarray(scene.vertices)
    lo, hi = v.min(0), v.max(0)
    r = np.random.RandomState(7)
    ro = (r.uniform(size=(n, 3)) * (hi - lo) + lo).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    yield ("incoherent", torch.as_tensor(ro, device=device),
           torch.as_tensor(rd, device=device), tmin, tmax)


def pixels_off(img, ref):
    """Share of pixels whose largest channel difference exceeds 1e-3."""
    return float((np.abs(img - ref).max(axis=-1) > 1e-3).mean())


def gate(device):
    size = 128
    scene = wisp_cloud(n_blobs=2, tris_per_blob=8192, seed=3)
    camera = camera_of(size)
    n = size * size
    print(f"scene: {scene.num_faces} tris; {n} rays/set; device {device}",
          flush=True)
    kernels = {
        "multidomain": MultiDomainClusterIntersector(scene, n_domains=4,
                                                     device=device),
        "cluster1dom": ClusterBVHIntersector(scene, device=device),
    }
    brute = BruteIntersector(scene, device=device)
    stats, all_ok = {}, True
    for rname, o, d, tmin, tmax in ray_sets(scene, camera, n, device):
        hr = brute.intersect(o, d, tmin, tmax)
        win = torch.where(hr.valid, hr.t * 1.5, torch.full_like(hr.t, 20.0))
        occ_r = brute.occluded(o, d, win)
        for kname, isect in kernels.items():
            t0 = time.perf_counter()
            hk = isect.intersect(o, d, tmin, tmax)
            occ_k = isect.occluded(o, d, win)
            s = hit_mismatch(hr, hk, TOL, TOL)
            occ_bad = float((occ_k != occ_r).float().mean())
            ok = max(s["valid_mismatch"], s["t_bad"], s["prim_mismatch_nontie"],
                     occ_bad) < BOUND
            stats[f"{kname}/{rname}"] = {
                "valid_mismatch": s["valid_mismatch"], "t_bad": s["t_bad"],
                "prim_mismatch_nontie": s["prim_mismatch_nontie"],
                "occ_mismatch": occ_bad, "ok": ok,
                "wall_s": time.perf_counter() - t0}
            all_ok &= ok

    cfg = RenderConfig(spp=1, bounces=2, integrator="pt", seed=0)
    img_k = render_device(scene, camera, cfg, kernels["multidomain"], device=device)
    img_c = render_device(scene, camera, cfg, kernels["cluster1dom"], device=device)
    frac = pixels_off(img_k, img_c)
    stats["frame_md_vs_1dom"] = {"pix_off_frac": frac, "ok": frac < BOUND}
    all_ok &= frac < BOUND

    cam64 = camera_of(64)
    img_k64 = render_device(scene, cam64, cfg, kernels["multidomain"],
                            device=device)
    img_o64 = render_oracle(scene, cam64, cfg, pixel_chunk=1024, device=device)
    frac = pixels_off(img_k64, img_o64)
    stats["frame_vs_oracle64"] = {"pix_off_frac": frac, "ok": frac < BOUND}
    all_ok &= frac < BOUND
    return bool(all_ok), stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    device = resolve_device(ap.parse_args(argv).device)
    ok, stats = gate(device)
    print("PARITY_GATE " + json.dumps({"ok": ok, "device": str(device),
                                       "detail": stats}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
