"""Public API: render / make_pipeline (counterpart of ``spray_tpu/render.py``).

The default intersector is the multi-domain cluster intersector, whose
traversal runs in the hand-written CUDA kernels on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from .core.config import RenderConfig
from .core.device import resolve_device
from .integrators.device import make_render_fn
from .integrators.wavefront import make_scene_arrays
from .kernels.multidomain import MultiDomainClusterIntersector


def default_intersector(scene, device=None):
    """The multi-domain cluster intersector over the CUDA kernels."""
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
    """A frame step for benchmarking.  run() -> (image, rays_traced) with the
    device synchronised; rays_traced(out) is the count of actual trace
    activations (the Grays/s numerator)."""

    _fn: object
    _args: tuple
    device: torch.device

    def run(self):
        out = self._fn(*self._args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    @staticmethod
    def rays_traced(out):
        return int(out[1])


def make_pipeline(scene, camera, cfg: RenderConfig, backward=False,
                  intersector=None, device=None):
    if backward:
        raise NotImplementedError(
            "the differentiable pipeline is not ported yet (forward only)"
        )
    device = resolve_device(device)
    if intersector is None:
        intersector = default_intersector(scene, device=device)
    fn = make_render_fn(scene, camera, cfg, intersector, with_stats=True,
                        device=device)
    return Pipeline(fn, (make_scene_arrays(scene, device),), device)
