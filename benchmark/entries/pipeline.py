"""`spray_tpu_torch.render.make_pipeline(...).run()`: the forward frame, or
with the traffic's `backward` the training step (loss and gradients of
the vertices and albedo)."""

from __future__ import annotations

from benchmark.entries._common import build_intersector, program_inputs


class Entry:
    def __init__(self, ctx, reuse=None):
        from spray_tpu_torch.kernels import traverse  # noqa: PLC0415
        from spray_tpu_torch.render import make_pipeline  # noqa: PLC0415

        if "frame_seeds" in ctx.traffic:
            raise ValueError("the pipeline entry renders --seed's frame "
                             "only; frame_seeds is for the ooc entry")
        scene, camera, cfg = program_inputs(ctx)
        self.intersector, self.build_s = build_intersector(ctx, scene, reuse)
        self.backward = bool(ctx.traffic["backward"])
        self.pipe = make_pipeline(scene, camera, cfg, backward=self.backward,
                                  intersector=self.intersector,
                                  device=ctx.device)
        self._launches = traverse.launches

    def step(self):
        return self.pipe.run()

    def output(self, out):
        if self.backward:
            loss, grads, _ = out
            return {"loss": float(loss), "grads": dict(grads)}
        return {"image": out[0]}

    def counters(self):
        return {f"launches.{k}": v for k, v in self._launches.items()}
