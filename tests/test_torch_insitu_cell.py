"""The in-situ deployment of the benchmark's cell `wisp2m-insitu.frame-spp1`
on gloo ranks, cut to a scene and frame the CPU renders in seconds: 64
domains owned by 4 ranks, rays queued over bucketed all-to-all rounds.

- the frame agrees with the plain reference (`benchmark/reference`, plain
  PyTorch) at the same seed, for the renderer's own seed and for frames
  of other seeds rendered over the one build (`render(seed=)`);
- `render(seed=s)` is bit-equal to a renderer built with seed s, and
  builds no partition;
- under torch.profiler (2 ranks) every `spray.dist.*` span lies on rank 0
  inside a `spray.glue.*` span, and the counters `dist_rounds` and
  `rays_exchanged` equal the frame's `last_stats`; with no profiler
  nothing is counted."""

import contextlib
import signal

import numpy as np
import pytest
import torch

import torch_insitu_cell_worker as W
from benchmark import check
from benchmark.reference.render import Reference
from spray_tpu_torch.dist.launch import run_world

WORLD = 4
TRACED_WORLD = 2
LIMIT_S = 420  # each test, and each world's run
# the share of lit pixels off the reference, as in the md21 cells' limit
# (0.03): the port tests triangles with Woop's transform and the reference
# with Möller–Trumbore, so a ray grazing an edge or a tie between two
# triangles can take the other triangle on one side (PERF.md §4)
MISMATCH = 0.03
DIST = {"spray.dist.route", "spray.dist.exchange", "spray.dist.trace",
        "spray.dist.commit", "spray.dist.reduce", "spray.dist.gather"}


@contextlib.contextmanager
def time_limit(seconds):
    """Raise TimeoutError in this (the test's main) thread after `seconds`."""
    def expire(signum, frame):
        raise TimeoutError(f"over its time limit of {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def each_test_limited():
    with time_limit(LIMIT_S):
        yield


@pytest.fixture(scope="module")
def frames():
    """Every rank's frames (4 ranks)."""
    with time_limit(LIMIT_S):
        return run_world(W.frames_rank, WORLD, device="cpu")


@pytest.fixture(scope="module")
def traced():
    """Rank 0's traced frame (2 ranks)."""
    with time_limit(LIMIT_S):
        return run_world(W.traced_rank, TRACED_WORLD, device="cpu")[0]


@pytest.fixture(scope="module")
def reference():
    return Reference(W.scene_arrays(), "cpu")


def _mismatch(reference, img, seed):
    cam = W.camera_basis()
    ids = np.arange(cam["width"] * cam["height"])
    cfg = check.reference_cfg({"spp": W.CFG.spp, "bounces": W.CFG.bounces,
                               "nee": W.CFG.nee}, seed)
    px = reference.pixels(cam, cfg, torch.as_tensor(ids))
    return check.pixel_mismatch(img, px, ids)


@pytest.mark.parametrize("which", ["own", *W.SEEDS])
def test_four_ranks_match_the_plain_reference(frames, reference, which):
    out = frames[0]
    if which == "own":
        img, seed = out["img"], W.CFG.seed
    else:
        img, seed = out["by_seed"][which], which
    assert img.shape == (W.CAMERA["height"], W.CAMERA["width"], 3)
    assert np.isfinite(img).all() and (img > 0).any()
    assert _mismatch(reference, img, seed) < MISMATCH


def test_every_rank_gathers_the_same_frame(frames):
    for r in frames[1:]:
        np.testing.assert_array_equal(r["img"], frames[0]["img"])
        for s in W.SEEDS:
            np.testing.assert_array_equal(r["by_seed"][s],
                                          frames[0]["by_seed"][s])


@pytest.mark.parametrize("seed", W.SEEDS)
def test_render_seed_is_bit_equal_to_a_renderer_built_with_it(frames, seed):
    out = frames[0]
    np.testing.assert_array_equal(out["by_seed"][seed],
                                  out["built_with_seed"][seed])
    # another seed draws other paths: another frame
    assert not np.array_equal(out["by_seed"][seed], out["img"])


def test_render_seed_builds_no_partition(frames):
    for out in frames:
        assert out["built_once"] == 1
        assert out["builds_after_seeds"] == 1  # render(seed=) built none
        assert out["builds"] == 1 + len(W.SEEDS)
        # the renderer's own frame again, after other seeds: unchanged
        np.testing.assert_array_equal(out["again"], out["img"])


def test_rays_queue_over_rounds_within_max_epochs(frames):
    """Each wavefront's rays fill more than a round's buckets, and no call
    of the loop is cut off at max_epochs."""
    stats = frames[0]["stats"]
    calls = 2 * W.CFG.bounces + 1  # intersect each bounce, occluded but last
    assert stats["epochs"] > 2 * calls
    assert stats["epochs"] < W.RENDERER["max_epochs"] * calls
    assert stats["rays_exchanged"] > 0


def _inside(iv, outer):
    return any(o[1] <= iv[1] and iv[2] <= o[2] for o in outer)


def test_dist_spans_lie_inside_glue_spans_on_rank_0(traced):
    spans = traced["spans"]
    names = {name for name, _, _ in spans}
    assert DIST <= names
    assert "spray.sync.dist" in names
    glue = [iv for iv in spans if iv[0].startswith("spray.glue.")]
    frame = [iv for iv in spans if iv[0] == "spray.frame"]
    assert len(frame) == 1
    for iv in spans:
        if iv[0].startswith("spray.dist."):
            assert _inside(iv, glue), iv
        assert _inside(iv, frame), iv
    # the loop's stretches lie in the glue's intersect and nee spans
    calls = [iv for iv in glue if iv[0] in ("spray.glue.intersect",
                                            "spray.glue.nee")]
    for iv in spans:
        if iv[0] in DIST - {"spray.dist.gather"}:
            assert _inside(iv, calls), iv


def test_counters_equal_the_frames_last_stats(traced):
    after, stats = traced["after"], traced["stats"]
    assert after["dist_rounds"] == stats["epochs"] > 0
    assert after["rays_exchanged"] == stats["rays_exchanged"] > 0


def test_nothing_is_counted_without_a_profiler(traced):
    assert "dist_rounds" not in traced["before"]
    assert "rays_exchanged" not in traced["before"]
    # a frame rendered after the window adds nothing to its totals
    assert traced["later"] == traced["after"]
