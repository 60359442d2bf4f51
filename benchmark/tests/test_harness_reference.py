"""The benchmark's own scene generator and plain reference, held against
the program's CPU path (this test may import both; the benchmark's
reference imports nothing of the program)."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, scenes
from benchmark.reference import rng as ref_rng
from benchmark.reference.intersect import BoxCullIntersector
from benchmark.reference.render import Reference, make_camera

BENCH = Path(__file__).resolve().parents[1]
CFG = {"spp": 2, "bounces": 2, "seed": 2**31 + 12345, "nee": True,
       "background": (0.0, 0.0, 0.0)}


@pytest.mark.parametrize("kw", [
    dict(n_blobs=8, tris_per_blob=2048, seed=3),
    dict(n_blobs=3, tris_per_blob=300, seed=5),
    dict(n_blobs=2, tris_per_blob=20, seed=3, layout="random"),
])
def test_frozen_scene_equals_the_programs_bit_for_bit(kw):
    from spray_tpu_torch.io.scenes import wisp_cloud  # noqa: PLC0415

    mine, theirs = scenes.wisp_cloud(**kw), wisp_cloud(**kw)
    for k, v in mine.items():
        other = getattr(theirs, k)
        assert v.dtype == other.dtype and v.tobytes() == other.tobytes(), k


def test_camera_equals_the_programs():
    from spray_tpu_torch.core.camera import make_camera as theirs  # noqa: PLC0415

    args = ((14, 10, 18), (0, 0, 0), (0, 1, 0), 45, 40, 30)
    mine, cam = make_camera(*args), theirs(*args)
    for k in ("eye", "lower_left", "du", "dv"):
        assert mine[k].tobytes() == getattr(cam, k).tobytes()


def test_rng_equals_the_programs():
    from spray_tpu_torch.core import rng  # noqa: PLC0415

    pix = torch.arange(0, 5000, 7)
    smp = torch.full_like(pix, 3)
    for seed in (0, 7, 2**31 + 5, 2**32 + 9):
        for dim in (0, 9, 77):
            a = ref_rng.uniform(seed, pix, smp, dim)
            b = rng.uniform(seed, pix, 3, dim)
            assert torch.equal(a, b)


def test_box_culling_gives_the_answers_of_testing_every_triangle():
    sc = scenes.wisp_cloud(n_blobs=3, tris_per_blob=300, seed=3)
    v = torch.as_tensor(sc["vertices"])
    f = torch.as_tensor(sc["faces"].astype(np.int64))
    isect = BoxCullIntersector(v, f)
    g = torch.Generator().manual_seed(0)
    o = (torch.rand((3000, 3), generator=g) - 0.5) * 30
    d = torch.nn.functional.normalize(torch.randn((3000, 3), generator=g), dim=1)
    tmin = torch.zeros(3000)
    tmax = torch.full((3000,), float("inf"))
    t, prim = isect.intersect(o, d, tmin, tmax)
    tv = v[f.reshape(-1)].reshape(-1, 3, 3)
    from benchmark.reference.intersect import moller_trumbore  # noqa: PLC0415

    tt, ok = moller_trumbore(o[:, None], d[:, None], tv[None, :, 0],
                             tv[None, :, 1] - tv[None, :, 0],
                             tv[None, :, 2] - tv[None, :, 0])
    tt = torch.where(ok & (tt >= 0), tt, float("inf"))
    best = tt.min(dim=1)
    want_prim = torch.where(torch.isfinite(best.values), best.indices, -1)
    assert (want_prim >= 0).sum() > 300
    assert torch.equal(prim, want_prim)
    assert torch.equal(t[prim >= 0], best.values[prim >= 0])
    occ = isect.occluded(o, d, torch.where(prim >= 0, t * 1.01, 5.0))
    assert torch.equal(occ, torch.isfinite(best.values) & (best.values < torch.where(prim >= 0, t * 1.01, 5.0)))


def program_inputs(sc, cam, cfg):
    from spray_tpu_torch.core.config import RenderConfig  # noqa: PLC0415
    from spray_tpu_torch.core.types import Camera, Scene  # noqa: PLC0415

    rc = RenderConfig(width=cam["width"], height=cam["height"], spp=cfg["spp"],
                      bounces=cfg["bounces"], seed=cfg["seed"],
                      integrator="pt", nee=True)
    return Scene(**sc), Camera(**cam), rc


@pytest.fixture(scope="module")
def tiny():
    sc = scenes.wisp_cloud(n_blobs=3, tris_per_blob=300, seed=3)
    cam = make_camera((9, 6, 11), (0, 0, 0), (0, 1, 0), 45, 20, 20)
    return sc, cam, Reference(sc, "cpu")


def test_reference_image_equals_the_programs_cpu_path(tiny):
    from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector  # noqa: PLC0415
    from spray_tpu_torch.render import make_pipeline  # noqa: PLC0415

    sc, cam, ref = tiny
    scene, camera, rc = program_inputs(sc, cam, CFG)
    isect = MultiDomainClusterIntersector(scene, n_domains=2, device="cpu")
    img, _ = make_pipeline(scene, camera, rc, intersector=isect,
                           device="cpu").run()
    ids = check.sample_pixels(CFG["seed"], 400, 400)
    px = ref.pixels(cam, CFG, torch.as_tensor(ids))
    assert float(px.abs().sum()) > 0
    assert check.pixel_mismatch(img.numpy(), px, ids) == 0.0


def test_reference_loss_and_gradients_equal_the_programs_cpu_path(tiny):
    from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector  # noqa: PLC0415
    from spray_tpu_torch.render import LOSS_WEIGHTS, make_pipeline  # noqa: PLC0415

    sc, cam, ref = tiny
    scene, camera, rc = program_inputs(sc, cam, CFG)
    isect = MultiDomainClusterIntersector(scene, n_domains=2, device="cpu")
    loss, grads, _ = make_pipeline(scene, camera, rc, backward=True,
                                   intersector=isect, device="cpu").run()
    ref_loss, ref_grads = ref.loss_and_grads(cam, CFG, LOSS_WEIGHTS,
                                             block=256)
    assert check.loss_gap(loss, ref_loss) < 1e-5
    for k, g in ref_grads.items():
        assert float(g.norm()) > 0
        assert torch.allclose(grads[k], g, rtol=1e-4, atol=1e-6), k
    assert check.grad_norm_gap(grads, ref_grads) < 1e-5


def test_the_bfloat16_control_fails_the_check(tiny):
    sc, cam, ref = tiny
    low = Reference(sc, "cpu", torch.bfloat16)
    ids = check.sample_pixels(CFG["seed"], 400, 400)
    want = ref.pixels(cam, CFG, torch.as_tensor(ids))
    got = low.pixels(cam, CFG, torch.as_tensor(ids))
    img = np.zeros((400, 3), np.float32)
    img[ids] = got.numpy()
    share = check.pixel_mismatch(img.reshape(20, 20, 3), want, ids)
    for limits in (BENCH / "limits").glob("*.json"):
        lim = json.loads(limits.read_text())["limits"]
        if "pixel_mismatch" in lim:
            assert share > 10 * lim["pixel_mismatch"], limits.name


def imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in (BENCH / "reference").glob("*.py"):
        for mod in imported_modules(path):
            assert mod.split(".")[0] in ("torch", "numpy", "math",
                                         "__future__"), (path.name, mod)


def test_nothing_reads_the_repos_older_measuring_scripts():
    banned = ("bench.py", "bench_torch.py", "chip_smoke.py", "profiling")
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        text = path.read_text()
        for name in banned:
            assert name not in text, (path.name, name)
        for mod in imported_modules(path):
            assert mod.split(".")[0] not in ("bench", "bench_torch",
                                             "chip_smoke", "profiling",
                                             "jax", "spray_tpu"), (path, mod)
