"""Rank bodies of the port's distributed tests (spray_tpu_torch.dist).

Ranks are spawned processes that unpickle their function by module name, so
these bodies live here, in a module that imports torch and spray_tpu_torch
only: a rank never imports JAX, the JAX package or a test module.

Run as a script it is one rank of the two-process test:

    python tests/torch_dist_worker.py <rank> <world_size> <store_path>

joins a gloo group through the FileStore at store_path, renders its shard
of the in-situ frame and checks it against a single-process render; prints
'MP_OK <rank>' on success.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from spray_tpu_torch import dist as sdist  # noqa: E402
from spray_tpu_torch.core.camera import make_camera  # noqa: E402
from spray_tpu_torch.core.config import RenderConfig  # noqa: E402
from spray_tpu_torch.dist import rayshard  # noqa: E402
from spray_tpu_torch.dist.epochs import (  # noqa: E402
    CollectiveEpochIntersector, make_insitu_diff_fn, make_insitu_renderer,
)
from spray_tpu_torch.io.scenes import cornell_box, wisp_cloud  # noqa: E402

CPU = "cpu"
RAYSHARD_CAM = dict(eye=(0.5, 0.5, 2.2), lookat=(0.5, 0.5, 0.0), up=(0, 1, 0),
                    fov_y_deg=40, width=40, height=40)
RAYSHARD_FWD = RenderConfig(spp=2, bounces=2, integrator="pt", seed=9)
RAYSHARD_GRAD = RenderConfig(spp=1, bounces=1, integrator="pt", seed=3)
EPOCHS_SCENE = dict(n_blobs=8, tris_per_blob=80, extent=4.0, seed=11)
EPOCHS_CAM = dict(eye=(10, 7, 14), lookat=(0, 0, 0), up=(0, 1, 0),
                  fov_y_deg=45, width=32, height=32)
# the configurations of tests/test_dist_epochs.py, by case
EPOCHS_CASES = {
    "single": (RenderConfig(spp=1, bounces=2, integrator="pt", seed=6,
                            background=(0.4, 0.5, 0.7)),
               dict(n_domains=16, bucket=256)),
    "small_bucket": (RenderConfig(spp=1, bounces=1, integrator="pt", seed=2),
                     dict(n_domains=8, bucket=32, max_epochs=128)),
    "cluster": (RenderConfig(spp=1, bounces=1, integrator="pt", seed=4),
                dict(n_domains=16, bucket=256, backend="cluster")),
    "jnp": (RenderConfig(spp=1, bounces=1, integrator="pt", seed=4),
            dict(n_domains=16, bucket=256, backend="jnp")),
    "stats": (RenderConfig(spp=1, bounces=2, integrator="pt", seed=6),
              dict(n_domains=16, bucket=256)),
    "stats_k2": (RenderConfig(spp=1, bounces=2, integrator="pt", seed=6),
                 dict(n_domains=16, bucket=256)),
}
# cases whose intersector reads the global count once every k rounds
ROUNDS_PER_CHECK = {"stats_k2": 2}
DIFF_CFG = RenderConfig(spp=1, bounces=1, integrator="pt", seed=3)
DIFF_KW = dict(n_domains=64, bucket=256)
MP_SCENE = dict(n_blobs=4, tris_per_blob=256, seed=5)
MP_CAM = dict(eye=(10.0, 8.0, 14.0), lookat=(0, 0, 0), up=(0, 1, 0),
              fov_y_deg=45, width=32, height=32)
MP_CFG = RenderConfig(spp=1, bounces=1, integrator="pt", seed=0)


def scene_params(scene, names=("vertices", "albedo")):
    return {k: torch.as_tensor(np.asarray(getattr(scene, k), np.float32))
            for k in names}


def rank_info(rank, world_size, fail_rank=None):
    """(rank, world size, backend, CPU threads); raises on fail_rank."""
    if rank == fail_rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return (rank, world_size, torch.distributed.get_backend(),
            torch.get_num_threads())


def rayshard_rank(rank, world_size):
    """sharded_render of the Cornell box and one sharded gradient step:
    the image, the loss, the albedo gradient and the collectives counted."""
    scene = cornell_box()
    cam = make_camera(**RAYSHARD_CAM)
    img = rayshard.sharded_render(scene, cam, RAYSHARD_FWD, device=CPU)
    step = rayshard.make_sharded_render_grad(scene, cam, RAYSHARD_GRAD,
                                             device=CPU)
    ids, _ = rayshard.padded_pixel_ids(cam, world_size)
    sdist.reset_collectives()
    shard, loss, grads = step(scene_params(scene, ("albedo",)), ids)
    return {"img": img, "shard": shard.numpy(), "loss": float(loss),
            "albedo": grads["albedo"].numpy(),
            "collectives": dict(sdist.collectives)}


def epochs_rank(rank, world_size):
    """Every case of the in-situ renderer on the epochs scene, and the
    differentiable step: images, last_stats, collectives, loss and grads."""
    scene = wisp_cloud(**EPOCHS_SCENE)
    cam = make_camera(**EPOCHS_CAM)
    out = {}
    orig = CollectiveEpochIntersector.__init__
    for name, (cfg, kw) in EPOCHS_CASES.items():
        k = ROUNDS_PER_CHECK.get(name, 1)

        def patched(self, *a, _k=k, **kwargs):
            orig(self, *a, **kwargs, rounds_per_check=_k)

        CollectiveEpochIntersector.__init__ = patched
        try:
            sdist.reset_collectives()
            render = make_insitu_renderer(scene, cam, cfg, device=CPU, **kw)
            out[name] = {"img": render(), "stats": render.last_stats,
                         "collectives": dict(sdist.collectives)}
        finally:
            CollectiveEpochIntersector.__init__ = orig
    step = make_insitu_diff_fn(scene, cam, DIFF_CFG, device=CPU, **DIFF_KW)
    loss, grads = step(scene_params(scene))
    out["diff"] = {"loss": float(loss),
                   **{k: g.numpy() for k, g in grads.items()}}
    return out


SCALING_SCENE = dict(n_blobs=4, tris_per_blob=512, seed=5)  # tests/test_scaling.py's


def scaling_rank(rank, world_size):
    """Weak scaling of the ray-sharded step: (t_independent, t_distributed)
    of this rank, measured back to back by the scaling curve's own body
    (`spray_tpu_torch.dist.scaling.rayshard_times`), on the reference
    test's scene with 3 timed calls of each."""
    from spray_tpu_torch.dist.scaling import rayshard_times

    return rayshard_times(rank, world_size, SCALING_SCENE, iters=3)


def _main():
    from spray_tpu_torch.dist.launch import init_rank
    from spray_tpu_torch.integrators.device import render_device

    rank, world_size, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_rank(store, rank, world_size, CPU)
    try:
        scene = wisp_cloud(**MP_SCENE)
        cam = make_camera(**MP_CAM)
        render = make_insitu_renderer(scene, cam, MP_CFG, n_domains=8,
                                      bucket=512, max_epochs=32, device=CPU)
        pids, vals = render.local()
    finally:
        torch.distributed.destroy_process_group()
    ref = render_device(scene, cam, MP_CFG, device=CPU).reshape(-1, 3)
    err = float(np.abs(vals - ref[pids]).max())
    assert err < 1e-4, f"rank {rank}: local shard mismatch {err}"
    print(f"MP_OK {rank} pixels={len(pids)} maxerr={err:.2e} "
          f"jax_imported={'jax' in sys.modules}", flush=True)


if __name__ == "__main__":
    _main()
