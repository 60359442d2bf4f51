"""Public API: render / make_pipeline (counterpart of ``spray_tpu/render.py``).

`default_intersector` is the reference's selector: brute force for tiny
scenes, else the multi-domain cluster intersector on the card and the
stackful BVH walk on the CPU, with the binned, sweep and brute-kernel
intersectors on request.  Their traversal runs in the hand-written CUDA
kernels on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import trace
from .bvh.traverse import BVHIntersector
from .core.config import RenderConfig
from .core.device import resolve_device
from .diff import grads_of, make_diff_render_fn
from .integrators.device import make_render_fn
from .integrators.wavefront import make_scene_arrays
from .kernels.multidomain import MultiDomainClusterIntersector
from .oracle.brute import BruteIntersector

PREFER = ("auto", "brute", "binned", "sweep", "pallas", "multidomain")


def default_intersector(scene, prefer="auto", device=None):
    """Intersector for the scene, with the reference's `prefer` values.

    "brute", and "auto" at <= 256 triangles: the torch `BruteIntersector`.
    "binned": `BinnedIntersector` (for coherent primary-ray workloads).
    "sweep": `SweepIntersector`.
    "pallas", "multidomain", and "auto" on the card: the multi-domain
    cluster intersector over the CUDA traversal kernels.  "auto" on the CPU:
    the stackful `BVHIntersector`, as the reference off the TPU (the card
    is the port's analog of the TPU).
    """
    if prefer not in PREFER:
        raise ValueError(f"prefer: want one of {PREFER}, got {prefer!r}")
    ntris = int(np.asarray(scene.faces).shape[0])
    if prefer == "brute" or (prefer == "auto" and ntris <= 256):
        return BruteIntersector(scene, device=device)
    if prefer == "binned":
        from .kernels.binned import BinnedIntersector  # noqa: PLC0415

        return BinnedIntersector(scene, device=device)
    if prefer == "sweep":
        from .kernels.sweep import SweepIntersector  # noqa: PLC0415

        return SweepIntersector(scene, device=device)
    device = resolve_device(device)
    if prefer == "auto" and device.type != "cuda":
        return BVHIntersector(scene, device=device)
    return MultiDomainClusterIntersector(scene, device=device)


def render(scene, camera, cfg: RenderConfig = RenderConfig(), intersector=None,
           device=None):
    """Render a frame -> (H, W, 3) float32 numpy image."""
    device = resolve_device(device)
    if intersector is None:
        intersector = default_intersector(scene, device=device)
    fn = make_render_fn(scene, camera, cfg, intersector, device=device)
    return fn(make_scene_arrays(scene, device)).cpu().numpy()


@dataclasses.dataclass
class Pipeline:
    """A frame step for benchmarking and training.  run() returns the step's
    outputs with the device synchronised: (image, rays_traced) forward,
    (loss, grads, rays_traced) with backward; rays_traced(out) is the count
    of actual trace activations (the Grays/s numerator)."""

    _fn: object
    _args: tuple
    device: torch.device
    _stats_index: int = 1

    def run(self):
        with trace.span("spray.step"):
            out = self._fn(*self._args)
            if self.device.type == "cuda":
                with trace.sync("step"):
                    torch.cuda.synchronize(self.device)
        return out

    def rays_traced(self, out):
        return int(out[self._stats_index])


LOSS_WEIGHTS = (0.4, 0.8, 1.3)  # per-channel weights of the bench loss


def make_pipeline(scene, camera, cfg: RenderConfig, backward=False,
                  intersector=None, device=None):
    """Forward frame step, or with backward the training step: loss =
    mean(image * LOSS_WEIGHTS) and its gradients w.r.t. the scene's
    vertices and albedo."""
    device = resolve_device(device)
    if intersector is None:
        intersector = default_intersector(scene, device=device)
    if not backward:
        fn = make_render_fn(scene, camera, cfg, intersector, with_stats=True,
                            device=device)
        return Pipeline(fn, (make_scene_arrays(scene, device),), device)

    render_fn = make_diff_render_fn(
        scene, camera, cfg, make_intersector=lambda s: intersector,
        with_stats=True, device=device)
    w = torch.tensor(LOSS_WEIGHTS, dtype=torch.float32, device=device)

    def step(params):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with trace.span("spray.autograd.forward"):
            img, nrays = render_fn(p)
            loss = torch.mean(img * w)
        with trace.span("spray.autograd.backward"):
            grads = grads_of(loss, p)
        return loss.detach(), grads, nrays

    params = {
        k: torch.as_tensor(np.asarray(getattr(scene, k), np.float32),
                           device=device)
        for k in ("vertices", "albedo")
    }
    return Pipeline(step, (params,), device, _stats_index=2)
