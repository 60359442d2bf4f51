"""`spray_tpu_torch.integrators.device.render_device` through the
configuration's out-of-core intersector (`OOCIntersector`): the host-driven
epoch scheduler with its residency slots.  A frame ends with its image on
the host.  The frames cycle through `frame_seeds(ctx)`."""

from __future__ import annotations

import dataclasses
import itertools
import sys

import numpy as np
import torch

from benchmark.entries._common import (build_intersector, frame_seeds,
                                       program_inputs)


def warm_probe_path(device):
    """A 1 MB host-to-device copy fenced by a reduction read on the host:
    the operations of `OOCIntersector`'s lookahead probe, made once before
    it.  In a fresh process the probe's first copy and reduction are slow
    to start: on an H100 it read 20-80 MB/s, around its 50 MB/s
    threshold, and opened lookahead in some processes and not in others;
    warm, it read 1.5-3 GB/s, and opens it in every run."""
    buf = torch.as_tensor(np.zeros(1 << 18, np.float32)).to(device)
    float(buf[:1].sum())


class Entry:
    def __init__(self, ctx, reuse=None):
        from spray_tpu_torch.integrators.device import render_device  # noqa: PLC0415

        scene, camera, cfg = program_inputs(ctx)
        warm_probe_path(ctx.device)
        self.intersector, self.build_s = build_intersector(ctx, scene, reuse)
        print(f"ooc: lookahead {self.intersector.lookahead}, host_to_hbm_mbps "
              f"{self.intersector.host_to_hbm_mbps}", file=sys.stderr,
              flush=True)
        cycle = itertools.cycle([dataclasses.replace(cfg, seed=s)
                                 for s in frame_seeds(ctx)])
        self.render_seed = cfg.seed

        def frame():
            c = next(cycle)
            self.render_seed = c.seed
            return render_device(scene, camera, c,
                                 intersector=self.intersector,
                                 device=ctx.device)

        self.step = frame

    def output(self, out):
        return {"image": out, "render_seed": self.render_seed}

    def counters(self):
        return dataclasses.asdict(self.intersector.stats)
