"""Rank bodies of tests/test_torch_insitu_cell.py: the in-situ deployment of
the benchmark's cell `wisp2m-insitu.frame-spp1` (`make_insitu_renderer`, 64
domains, bucketed all-to-all rounds) cut to a scene and frame the CPU
renders in seconds.

Ranks are spawned processes that unpickle their function by module name, so
these bodies live here, in a module that imports torch, spray_tpu_torch and
the benchmark's own scene and camera (plain numpy) only.
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark.profile import from_profiler  # noqa: E402
from benchmark.reference.render import make_camera  # noqa: E402
from benchmark.scenes import wisp_cloud  # noqa: E402
from spray_tpu_torch import trace  # noqa: E402
from spray_tpu_torch.core.config import RenderConfig  # noqa: E402
from spray_tpu_torch.core.types import Camera, Scene  # noqa: E402
from spray_tpu_torch.dist import epochs  # noqa: E402
from spray_tpu_torch.kernels import multidomain  # noqa: E402

CPU = "cpu"
SCENE = dict(n_blobs=2, tris_per_blob=4096, seed=3)  # 10,242 triangles
CAMERA = dict(eye=(14.0, 10.0, 18.0), lookat=(0.0, 0.0, 0.0),
              up=(0.0, 1.0, 0.0), fov_y_deg=45, width=40, height=40)
# the cell's frame: spp 1, bounces 2, PT+NEE, black background
CFG = RenderConfig(width=40, height=40, spp=1, bounces=2, integrator="pt",
                   nee=True, seed=657226250)
SEEDS = (1046690601, 2**31 + 77)
# 64 domains as in the cell; 400 rays a rank a wavefront and 100 a
# (source, owner) pair in a round, a quarter, as the cell's 65,536 of
# 262,144: rays queue over rounds
RENDERER = dict(n_domains=64, bucket=100, max_epochs=64, backend="cluster")


def scene_arrays():
    """The benchmark's arrays of the scene (numpy), as the reference takes
    them."""
    return wisp_cloud(**SCENE)


def camera_basis():
    return make_camera(**CAMERA)


def _renderer(cfg=CFG):
    return epochs.make_insitu_renderer(Scene(**scene_arrays()),
                                       Camera(**camera_basis()), cfg,
                                       device=CPU, **RENDERER)


def frames_rank(rank, world_size):
    """The frame of CFG, then of each of SEEDS through `render(seed=)` over
    the one build, then of renderers built with each of SEEDS: images,
    last_stats and the partitions built along the way."""
    builds = []
    orig = multidomain.build_cluster_domains

    def counted(*a, **kw):
        builds.append(1)
        return orig(*a, **kw)

    multidomain.build_cluster_domains = counted
    try:
        render = _renderer()
        out = {"built_once": len(builds), "img": render(),
               "stats": render.last_stats}
        out["by_seed"] = {s: render(seed=s) for s in SEEDS}
        out["again"] = render()
        out["builds_after_seeds"] = len(builds)
        out["built_with_seed"] = {
            s: _renderer(dataclasses.replace(CFG, seed=s))()
            for s in SEEDS}
        out["builds"] = len(builds)
    finally:
        multidomain.build_cluster_domains = orig
    return out


def traced_rank(rank, world_size):
    """One frame untraced, one under torch.profiler, one untraced again:
    the program's spans of the traced frame (name, start, end), its
    last_stats, and `trace.read()` before, right after and after the last
    frame."""
    render = _renderer()
    render()
    before = trace.read()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render()
    after = trace.read()
    stats = render.last_stats
    render()
    later = trace.read()
    spans = [(iv.name, iv.start_us, iv.end_us)
             for iv in from_profiler(prof).host
             if iv.name.startswith("spray.")]
    return {"spans": spans, "stats": stats, "before": before, "after": after,
            "later": later}
