"""`spray_tpu_torch.dist.epochs.make_insitu_renderer` on the cell's ranks:
the in-situ deployment, each rank owning a fixed slice of the domains on
its own card, rays moving to their owners in bucketed all-to-all rounds.

The configuration's `intersector` names the module, the intersector class
and the `renderer` function with its `options`.  The renderer is built
once a rank (timed as build_s) on the default process group, which the
harness has joined: the entry starts none.  The frames cycle through
`frame_seeds(ctx)`, each rendered by `render(seed=)` over that one build,
every rank the same seed in the same order.  A frame ends with the
gathered image on the host of every rank; rank 0's is checked.  The
renderer builds its intersector anew each frame, so `intersector` is the
class, which the faults wrap."""

from __future__ import annotations

import importlib
import itertools
import time

import torch

from benchmark.entries._common import frame_seeds, program_inputs


class Entry:
    def __init__(self, ctx, reuse=None):
        spec = ctx.config["intersector"]
        module = importlib.import_module(spec["module"])
        scene, camera, cfg = program_inputs(ctx)
        t0 = time.perf_counter()
        self.render = getattr(module, spec["renderer"])(
            scene, camera, cfg, device=ctx.device, **spec["options"])
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        self.build_s = time.perf_counter() - t0
        self.intersector = getattr(module, spec["class"])
        cycle = itertools.cycle(frame_seeds(ctx))
        self.render_seed = cfg.seed

        def frame():
            self.render_seed = next(cycle)
            return self.render(seed=self.render_seed)

        self.step = frame

    def output(self, out):
        return {"image": out, "render_seed": self.render_seed}

    def counters(self):
        # the renderer keeps no running totals: its counters are the
        # program's trace counters, which the readers read themselves
        return {}
