"""Device renderer: the full frame as one spp-batched wavefront, or one
wavefront per sample.

Counterpart of ``spray_tpu/integrators/device.py``.  The batched form
traces all spp samples of every pixel as ONE wavefront in
tile-swizzle order, the samples of a pixel adjacent, and accumulates the
image by a reshape to (npix, spp, 3) and a sum over samples, not a
scatter-add: on CUDA `index_add_` takes float atomics and is not
deterministic.  The per-sample form traces spp wavefronts of npix rays and
adds them in sample order: the same image within float rounding, at a peak
memory that does not grow with spp.  `make_render_fn` takes the batched
form when its wavefront fits in the device's free memory, else the
per-sample one.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..core.device import free_bytes, resolve_device
from ..kernels.common import tile_swizzle_order
from . import wavefront

# Device bytes a ray of the batched wavefront holds at the frame's peak,
# above what was allocated before the frame: 460 on an H100 at the bench
# frame (512x512, spp 4, PT+NEE, bounces 2, the multi-domain cluster
# intersector), which chip_smoke.py's phase 10 measures and holds to this.
RAY_BYTES = 512


def make_render_fn(scene, camera, cfg, intersector, with_stats=False,
                   device=None):
    """Build a frame fn: (scene_arrays) -> (H, W, 3) image tensor, or
    (image, rays_traced) with with_stats.

    The batched form traces all spp samples as one wavefront; the
    per-sample form one wavefront per sample (`wavefront.sample_sum`).  The
    counter RNG keys on (pixel, sample), so both trace the same rays.  The
    batched form is taken when npix * spp rays at RAY_BYTES a ray fit in
    `free_bytes(device)` now, else the per-sample form: the choice the
    reference leaves to its `spp_batch` flag.  The fn's `spp_batch`
    attribute is the form taken.  The reference's `donate` (XLA buffer
    donation) has no counterpart: eager torch frees a wavefront's buffers
    as it goes."""
    device = resolve_device(device)
    npix = camera.width * camera.height
    spp = cfg.spp
    spp_batch = npix * spp * RAY_BYTES <= free_bytes(device)
    pids = torch.as_tensor(
        tile_swizzle_order(camera.width, camera.height).astype(np.int64),
        device=device,
    )
    if spp_batch:
        pix = pids.repeat_interleave(spp)
        smp = torch.arange(spp, dtype=torch.int64, device=device).repeat(npix)

    def render(scene_arrays):
        if spp_batch:
            rad, nrays = wavefront.sample_wavefront(
                scene_arrays, camera, cfg, intersector, smp, pix,
                with_stats=True)
            acc = rad.reshape(npix, spp, 3).sum(dim=1)
        else:
            acc, nrays = wavefront.sample_sum(scene_arrays, camera, cfg,
                                              intersector, pids, spp)
        with trace.span("spray.glue.accumulate"):
            img = torch.empty((npix, 3), dtype=torch.float32, device=device)
            img[pids] = acc
            img = (img * (1.0 / spp)).reshape(camera.height, camera.width, 3)
        return (img, nrays) if with_stats else img

    render.spp_batch = spp_batch
    return render


def render_device(scene, camera, cfg, intersector=None, device=None):
    """Render a frame on `device` -> (H, W, 3) float32 numpy image.
    Host-driven intersectors (the out-of-core scheduler, which runs
    residency I/O between epochs) get the eager per-sample loop.  The
    scene's arrays are built once for a scene and device
    (`wavefront.scene_arrays_for`)."""
    from ..render import default_intersector  # noqa: PLC0415

    with trace.span("spray.frame"):
        device = resolve_device(device)
        if intersector is None:
            intersector = default_intersector(scene, device=device)
        if getattr(intersector, "host_driven", False):
            img = wavefront.render(scene, camera, cfg, intersector, device)
        else:
            fn = make_render_fn(scene, camera, cfg, intersector,
                                device=device)
            img = fn(wavefront.scene_arrays_for(scene, device))
        with trace.sync("image"):
            return img.cpu().numpy()
