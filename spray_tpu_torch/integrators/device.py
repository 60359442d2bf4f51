"""Device renderer: the full frame as one spp-batched wavefront.

Counterpart of ``spray_tpu/integrators/device.py`` (its spp-batched form):
all spp samples of every pixel trace as ONE wavefront in tile-swizzle order,
the samples of a pixel adjacent.  The image is accumulated by a reshape to
(npix, spp, 3) and a sum over samples, not a scatter-add: on CUDA
`index_add_` takes float atomics and is not deterministic.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels.common import tile_swizzle_order
from . import wavefront


def make_render_fn(scene, camera, cfg, intersector, with_stats=False,
                   device=None):
    """Build a frame fn: (scene_arrays) -> (H, W, 3) image tensor, or
    (image, rays_traced) with with_stats."""
    device = resolve_device(device)
    npix = camera.width * camera.height
    spp = cfg.spp
    pids = torch.as_tensor(
        tile_swizzle_order(camera.width, camera.height).astype(np.int64),
        device=device,
    )
    pix = pids.repeat_interleave(spp)
    smp = torch.arange(spp, dtype=torch.int64, device=device).repeat(npix)

    def render(scene_arrays):
        rad, nrays = wavefront.sample_wavefront(
            scene_arrays, camera, cfg, intersector, smp, pix, with_stats=True
        )
        img = torch.empty((npix, 3), dtype=torch.float32, device=device)
        img[pids] = rad.reshape(npix, spp, 3).sum(dim=1)
        img = (img * (1.0 / spp)).reshape(camera.height, camera.width, 3)
        return (img, nrays) if with_stats else img

    return render


def render_device(scene, camera, cfg, intersector=None, device=None):
    """Render a frame on `device` -> (H, W, 3) float32 numpy image.
    Host-driven intersectors (the out-of-core scheduler, which runs
    residency I/O between epochs) get the eager per-sample loop."""
    from ..render import default_intersector  # noqa: PLC0415

    device = resolve_device(device)
    if intersector is None:
        intersector = default_intersector(scene, device=device)
    if getattr(intersector, "host_driven", False):
        img = wavefront.render(scene, camera, cfg, intersector, device)
        return img.cpu().numpy()
    fn = make_render_fn(scene, camera, cfg, intersector, device=device)
    return fn(wavefront.make_scene_arrays(scene, device)).cpu().numpy()
