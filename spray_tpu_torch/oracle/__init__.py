"""The port's reference renderer: the torch brute-force intersector through
the wavefront integrator (counterpart of ``spray_tpu/oracle``)."""

from __future__ import annotations

from ..core.device import resolve_device
from ..integrators import wavefront
from .brute import BruteIntersector


def render_oracle(scene, camera, cfg, pixel_chunk=16384, device=None):
    """Render with the brute-force path, `pixel_chunk` pixels a wavefront.
    Returns the (H, W, 3) float32 numpy image."""
    device = resolve_device(device)
    intersector = BruteIntersector(scene, device=device)
    return wavefront.render(scene, camera, cfg, intersector, device,
                            pixel_chunk=pixel_chunk).cpu().numpy()
