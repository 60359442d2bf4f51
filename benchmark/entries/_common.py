"""What the entry kinds share: the program's scene, camera, render config
and intersector, from the benchmark's own arrays and the configuration."""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch


def program_inputs(ctx):
    """(Scene, Camera, RenderConfig) of the program from the scene and
    camera the benchmark made and the traffic's frame."""
    from spray_tpu_torch.core.config import RenderConfig  # noqa: PLC0415
    from spray_tpu_torch.core.types import Camera, Scene  # noqa: PLC0415

    t = ctx.traffic
    cfg = RenderConfig(width=t["width"], height=t["height"], spp=t["spp"],
                       bounces=t["bounces"], seed=ctx.seed,
                       integrator=t["integrator"], nee=t["nee"])
    return Scene(**ctx.scene), Camera(**ctx.camera), cfg


def frame_seeds(ctx):
    """The `RenderConfig.seed` of each frame of one cycle of the window.
    With the traffic's `frame_seeds`, a fixed pool, every --seed renders
    the same frames, in an order drawn from --seed (the paths a seed draws
    change the work of a frame: the same set of frames keeps every run's
    work alike); without it, --seed alone."""
    pool = ctx.traffic.get("frame_seeds")
    if pool is None:
        return [ctx.seed]
    order = np.random.default_rng(ctx.seed).permutation(len(pool))
    return [int(pool[i]) for i in order]


def build_intersector(ctx, scene, reuse=None):
    """The configuration's intersector on the device, and the fenced host
    seconds its constructor took; `reuse`, an intersector built for the
    same configuration, is taken as it is (the correctness calibration
    renders many seeds over one build)."""
    if reuse is not None:
        return reuse, 0.0
    spec = ctx.config["intersector"]
    cls = getattr(importlib.import_module(spec["module"]), spec["class"])
    t0 = time.perf_counter()
    isect = cls(scene, device=ctx.device, **spec.get("options", {}))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return isect, time.perf_counter() - t0
