"""spray_tpu_torch imports no JAX and no spray_tpu, and its entry points
require the CUDA card unless the caller asks for the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_torch
import spray_tpu_torch
from spray_tpu_torch.core.camera import make_camera
from spray_tpu_torch.core.config import RenderConfig
from spray_tpu_torch.io.scenes import cornell_box
from tests_gpu import insitu_gate

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import spray_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "spray_tpu_torch.__path__, 'spray_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'spray_tpu'))\n"
        "print(json.dumps({'mods': mods, 'bad': bad}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "spray_tpu_torch.kernels.multidomain" in res["mods"]
    assert "spray_tpu_torch.render" in res["mods"]
    assert "spray_tpu_torch.sched.epochs" in res["mods"]
    assert "spray_tpu_torch.diff" in res["mods"]
    for m in ("brute", "binned", "sweep"):
        assert f"spray_tpu_torch.kernels.{m}" in res["mods"]
    for m in ("rayshard", "epochs", "launch", "dryrun", "scaling"):
        assert f"spray_tpu_torch.dist.{m}" in res["mods"]
    for m in ("native", "optim", "cli", "viewer", "oracle", "io.ply",
              "io.scene_file", "core.image", "parity"):
        assert f"spray_tpu_torch.{m}" in res["mods"]
    assert res["bad"] == []


def test_sources_have_no_jax_import_lines():
    files = [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"] + sorted(
        (ROOT / "tests_gpu").glob("*.py")) + sorted(
        Path(spray_tpu_torch.__file__).parent.rglob("*.py"))
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "spray_tpu"), f"{f}: {line}"


def test_entry_points_require_gpu(monkeypatch, tmp_path):
    """device=None means CUDA: with no card they raise, never run on CPU."""
    from spray_tpu_torch.diff import make_diff_render_fn, render_grad
    from spray_tpu_torch.integrators.device import render_device
    from spray_tpu_torch.kernels.binned import BinnedIntersector
    from spray_tpu_torch.kernels.brute import PallasBruteIntersector
    from spray_tpu_torch.kernels.sweep import SweepIntersector
    from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector
    from spray_tpu_torch.kernels.traverse import ClusterBVHIntersector
    from spray_tpu_torch.render import default_intersector, make_pipeline, render
    from spray_tpu_torch.residency.manager import ResidencyManager
    from spray_tpu_torch.sched.epochs import OOCIntersector
    from spray_tpu_torch.bvh.traverse import BVHIntersector
    from spray_tpu_torch.sched.multidomain import MultiDomainIntersector
    from spray_tpu_torch.dist.epochs import make_insitu_diff_fn, make_insitu_renderer
    from spray_tpu_torch.dist.launch import run_world
    from spray_tpu_torch.dist.rayshard import make_sharded_render_grad, sharded_render
    from spray_tpu_torch import cli
    from spray_tpu_torch.dist.scaling import curve, main as curve_main
    from spray_tpu_torch.optim import fit
    from spray_tpu_torch.oracle import render_oracle
    from spray_tpu_torch.viewer import InteractiveViewer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "img.ppm"
    scene = cornell_box()
    cam = make_camera(eye=(0.5, 0.5, 2.2), lookat=(0.5, 0.5, 0), up=(0, 1, 0),
                      fov_y_deg=40, width=8, height=8)
    cfg = RenderConfig(spp=1, bounces=1)
    albedo = torch.as_tensor(scene.albedo)
    for call in (lambda: render(scene, cam, cfg),
                 lambda: make_pipeline(scene, cam, cfg),
                 lambda: make_pipeline(scene, cam, cfg, backward=True),
                 lambda: MultiDomainClusterIntersector(scene),
                 lambda: ClusterBVHIntersector(scene),
                 lambda: BinnedIntersector(scene),
                 lambda: SweepIntersector(scene),
                 lambda: PallasBruteIntersector(scene),
                 lambda: default_intersector(scene, prefer="sweep"),
                 lambda: default_intersector(scene, prefer="brute"),
                 lambda: OOCIntersector(scene, n_domains=2, num_slots=1),
                 lambda: OOCIntersector(scene, n_domains=2, backend="jnp"),
                 lambda: BVHIntersector(scene),
                 lambda: MultiDomainIntersector(scene, n_domains=2),
                 lambda: ResidencyManager(2, lambda d: {}),
                 lambda: make_diff_render_fn(scene, cam, cfg),
                 lambda: render_grad(scene, cam, cfg, {"albedo": albedo}),
                 lambda: render_device(scene, cam, cfg),
                 lambda: make_insitu_renderer(scene, cam, cfg, device=None),
                 lambda: make_insitu_diff_fn(scene, cam, cfg, device=None),
                 lambda: sharded_render(scene, cam, cfg, device=None),
                 lambda: make_sharded_render_grad(scene, cam, cfg, device=None),
                 lambda: run_world(print, 1),
                 lambda: render_oracle(scene, cam, cfg),
                 lambda: fit(scene, cam, cfg, np.zeros((8, 8, 3)),
                             {"albedo": scene.albedo}, steps=1),
                 lambda: InteractiveViewer(scene, cfg, size=8),
                 lambda: cli.main(["render", "--builtin", "cornell", "--size",
                                   "8", "-o", str(out)]),
                 lambda: curve(world_sizes=(1,)),
                 lambda: curve_main([]),
                 lambda: insitu_gate.gate(scene, cam, cfg),
                 lambda: insitu_gate.main([]),
                 lambda: bench_torch.main(["--suite", "--size", "8"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not out.exists()  # the CLI raised before it rendered
    img = render(scene, cam, cfg, device="cpu")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    pipe = make_pipeline(scene, cam, cfg, backward=True, device="cpu")
    loss, grads, _ = pipe.run()
    assert torch.isfinite(loss) and set(grads) == {"vertices", "albedo"}
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_chip_smoke_fails_without_card():
    """chip_smoke.py exits nonzero and prints no result line here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py would run on it")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
