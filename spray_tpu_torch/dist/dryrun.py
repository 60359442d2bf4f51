"""The multi-rank dry run (counterpart of ``__graft_entry__.dryrun_multichip``):
one training step of the ray-sharded renderer, one frame of the in-situ
epoch renderer and one step of its differentiable form, on tiny scenes, in
every rank of a world started by `run_world`.  Prints one line of numbers.

    python -m spray_tpu_torch.dist.dryrun [N_RANKS] [--cpu]

runs N ranks (default 1) on N cards through NCCL, or with --cpu on the CPU
through gloo.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.camera import make_camera
from ..core.config import RenderConfig
from ..io.scenes import cornell_box, wisp_cloud
from .epochs import make_insitu_diff_fn, make_insitu_renderer
from .launch import run_world
from .rayshard import make_mesh, make_sharded_render_grad, padded_pixel_ids


def _dryrun_rank(rank, world_size, device):
    """The three parts in one rank; returns the line's numbers."""
    mesh = make_mesh(world_size, device=device)
    dev = mesh.device

    def tensors(scene):
        return {"albedo": torch.as_tensor(scene.albedo, device=dev),
                "vertices": torch.as_tensor(scene.vertices, device=dev)}

    # 1) pixels sharded against the replicated scene, grads all-reduced
    scene = cornell_box()
    camera = make_camera(eye=(0.5, 0.5, 2.2), lookat=(0.5, 0.5, 0.0),
                         up=(0, 1, 0), fov_y_deg=40, width=16, height=16)
    cfg = RenderConfig(spp=1, bounces=1, integrator="pt", seed=0)
    step = make_sharded_render_grad(scene, camera, cfg, mesh, device=device)
    ids, _ = padded_pixel_ids(camera, world_size)
    _, loss, grads = step(tensors(scene), ids)
    g = grads["albedo"].cpu().numpy()
    if not (np.isfinite(float(loss)) and np.isfinite(g).all()):
        raise RuntimeError("non-finite loss or grads in the rayshard step")

    # 2) domains owned per rank, rays exchanged in bucketed epochs
    wisp = wisp_cloud(n_blobs=4, tris_per_blob=40, extent=3.0, seed=1)
    cfg2 = RenderConfig(spp=1, bounces=1, integrator="pt",
                        background=(0.5, 0.6, 0.7))
    n_domains = max(8, world_size)
    img = make_insitu_renderer(wisp, camera, cfg2, mesh, n_domains=n_domains,
                               bucket=64, device=device)()
    if not (np.isfinite(img).all() and img.mean() > 0):
        raise RuntimeError("non-finite or black image in the in-situ frame")

    # 3) backward through the domain-sharded renderer
    diff_step = make_insitu_diff_fn(wisp, camera, cfg2, mesh,
                                    n_domains=n_domains, bucket=64,
                                    device=device)
    loss2, grads2 = diff_step(tensors(wisp))
    gv = grads2["vertices"].cpu().numpy()
    if not (np.isfinite(float(loss2)) and np.isfinite(gv).all()):
        raise RuntimeError("non-finite loss or vertex grads in the in-situ step")
    return {"rayshard_loss": float(loss), "rayshard_grad": float(np.abs(g).sum()),
            "insitu_mean": float(img.mean()), "insitu_diff_loss": float(loss2),
            "insitu_diff_dv": float(np.abs(gv).sum())}


def dryrun_multichip(n_devices, device=None):
    """Run the dry run in a world of n_devices ranks (device None: the
    cards, through NCCL; "cpu": gloo), print its line and return rank 0's
    numbers."""
    out = run_world(_dryrun_rank, n_devices, device, device=device)[0]
    print(f"dryrun_multichip({n_devices}): rayshard loss={out['rayshard_loss']:.6f} "
          f"|grad|={out['rayshard_grad']:.6f}; insitu mean={out['insitu_mean']:.4f}; "
          f"insitu-diff loss={out['insitu_diff_loss']:.6f} "
          f"|dV|={out['insitu_diff_dv']:.6f} ok", flush=True)
    return out


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    dryrun_multichip(int(args[0]) if args else 1,
                     device="cpu" if "--cpu" in sys.argv[1:] else None)
