"""spray_tpu_torch's host layers == spray_tpu's: PLY and scene description
files, the CLI apps, the viewer, the optimization loop with checkpoints,
the oracle and the bench entry (counterparts of tests/test_io_cli.py)."""

import io
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu import cli as jcli
from spray_tpu.core import camera as jcamera
from spray_tpu.core.config import RenderConfig as JConfig
from spray_tpu.diff import make_diff_render_fn as j_diff_render_fn
from spray_tpu.io import ply as jply
from spray_tpu.io import scene_file as jscene_file
from spray_tpu.io import scenes as js
from spray_tpu.optim import fit as j_fit
from spray_tpu.oracle import render_oracle as j_render_oracle
from spray_tpu.viewer import InteractiveViewer as JViewer
from spray_tpu.viewer import show_terminal as j_show_terminal
from spray_tpu_torch import cli
from spray_tpu_torch.core.camera import make_camera
from spray_tpu_torch.core.config import RenderConfig
from spray_tpu_torch.diff import make_diff_render_fn
from spray_tpu_torch.io import scenes as ts
from spray_tpu_torch.io.ply import read_ply, write_ply
from spray_tpu_torch.io.scene_file import load_scene, save_scene
from spray_tpu_torch.optim import fit, load_checkpoint
from spray_tpu_torch.oracle import render_oracle
from spray_tpu_torch.sched import epochs as port_epochs
from spray_tpu_torch.viewer import InteractiveViewer, show_terminal

ROOT = Path(__file__).resolve().parents[1]
CAM = dict(eye=(0.5, 0.5, 2.2), lookat=(0.5, 0.5, 0.0), up=(0, 1, 0),
           fov_y_deg=40, width=16, height=16)
FIT_LOSS_RTOL = 2e-3  # optax's and torch's Adam round in another order


def _run_cli(args):
    return subprocess.run(
        [sys.executable, "-m", "spray_tpu_torch.cli"] + args, cwd=ROOT,
        capture_output=True, text=True, timeout=300)


def _main_stdout(main, args, capsys):
    """Run an in-process CLI main and return what it printed."""
    capsys.readouterr()
    main(args)
    return capsys.readouterr().out


def _read_ppm(path):
    data = Path(path).read_bytes()
    magic, w, h, maxval, body = data.split(maxsplit=4)
    assert magic == b"P6" and maxval == b"255"
    return np.frombuffer(body, np.uint8).reshape(int(h), int(w), 3)


def test_ply_roundtrip_binary_and_ascii(tmp_path):
    s = ts.bumpy_sphere(subdiv=2)
    colors = np.random.RandomState(0).uniform(size=(len(s.vertices), 3))
    for binary in (True, False):
        pt, pj = tmp_path / f"t_{binary}.ply", tmp_path / f"j_{binary}.ply"
        write_ply(pt, s.vertices, s.faces, colors=colors, binary=binary)
        jply.write_ply(pj, s.vertices, s.faces, colors=colors, binary=binary)
        assert pt.read_bytes() == pj.read_bytes()
        m = read_ply(pt)
        np.testing.assert_allclose(m["vertices"], s.vertices, atol=1e-5)
        np.testing.assert_array_equal(m["faces"], s.faces)
        np.testing.assert_allclose(m["colors"], colors, atol=1 / 255.0)
        # each package reads the other's file as its own
        for a, b in ((read_ply(pj), jply.read_ply(pt)), (m, jply.read_ply(pj))):
            for k in ("vertices", "faces", "colors"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_scene_description_roundtrip(tmp_path):
    scene, jscene = ts.cornell_box(), js.cornell_box()
    assign = (np.arange(scene.num_faces) % 3).astype(np.int32)
    cam = {"eye": [0.5, 0.5, 2.2], "lookat": [0.5, 0.5, 0.0], "up": [0, 1, 0],
           "fov_y": 40, "width": 24, "height": 24}
    save_scene(tmp_path / "t" / "scene.json", scene, assign=assign, camera=cam)
    jscene_file.save_scene(tmp_path / "j" / "scene.json", jscene, assign=assign,
                           camera=cam)
    for f in sorted((tmp_path / "j").iterdir()):
        assert (tmp_path / "t" / f.name).read_bytes() == f.read_bytes(), f.name
    loaded, assign2, camera = load_scene(tmp_path / "t" / "scene.json")
    jloaded, jassign, jcam = jscene_file.load_scene(tmp_path / "t" / "scene.json")
    assert loaded.num_faces == scene.num_faces
    assert set(np.unique(assign2)) == {0, 1, 2}
    np.testing.assert_array_equal(assign2, jassign)
    for k in ("vertices", "faces", "albedo", "emission"):
        a, b = getattr(loaded, k), getattr(jloaded, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for k in ("eye", "lower_left", "du", "dv", "width", "height"):
        np.testing.assert_array_equal(getattr(camera, k), getattr(jcam, k))

    def tri_set(s):  # geometry kept up to the per-domain reordering
        v = np.asarray(s.vertices)[np.asarray(s.faces).reshape(-1)]
        return np.sort(v.reshape(-1, 9), axis=0)

    np.testing.assert_allclose(tri_set(loaded), tri_set(scene), atol=1e-5)


def test_cli_render_and_inspect(tmp_path, capsys):
    """The port's CLI as a subprocess on the CPU: its image within one u8
    level of the reference CLI's on the same arguments, its inspect JSON
    equal to the reference's."""
    args = ["render", "--builtin", "cornell", "--size", "32", "--spp", "1",
            "--bounces", "1"]
    out, jout = str(tmp_path / "img.ppm"), str(tmp_path / "jimg.ppm")
    r = _run_cli(args + ["-o", out, "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    jstats = json.loads(_main_stdout(jcli.main, args + ["-o", jout], capsys)
                        .strip().splitlines()[-1])
    assert stats["scene_tris"] == jstats["scene_tris"] == 36
    assert stats["backend"] == "cpu"
    assert set(stats) == set(jstats)
    img, jimg = _read_ppm(out), _read_ppm(jout)
    assert img.shape == (32, 32, 3)
    diff = np.abs(img.astype(int) - jimg.astype(int))
    assert diff.max() <= 1, diff.max()

    r2 = _run_cli(["inspect", "--builtin", "cornell"])
    assert r2.returncode == 0, r2.stderr[-2000:]
    info = json.loads(r2.stdout)
    assert info["triangles"] == 36 and info["emissive_faces"] == 2
    assert info == json.loads(_main_stdout(jcli.main, ["inspect", "--builtin",
                                                       "cornell"], capsys))


SCHED_KEYS = ("epochs", "rays_traced", "rays_speculated", "domain_loads",
              "residency_hits", "speculation_efficiency")


def test_cli_ooc_vs_baseline_scheduler(tmp_path, capsys, monkeypatch):
    """The speculative OOC app and the non-speculative baseline app give
    byte-identical images; their scheduler counters equal the reference
    CLI's on the same arguments.  Both schedulers decide their prefetch
    lookahead by timing one upload; it is held on in both (the port's
    threshold 0, the reference's clock a nanosecond a reading), as in
    tests/test_torch_ooc_jnp.py."""
    monkeypatch.setattr(port_epochs, "PROBE_MB_S", 0.0)
    ticks = itertools.count()
    outs = {}
    for sched in ("ooc", "baseline"):
        args = ["render", "--builtin", "cornell", "--size", "24", "--spp", "1",
                "--bounces", "1", "--scheduler", sched, "--domains", "4",
                "--slots", "2"]
        out = str(tmp_path / f"{sched}.ppm")
        stats = json.loads(_main_stdout(
            cli.main, args + ["-o", out, "--device", "cpu"], capsys))
        with monkeypatch.context() as mp:
            mp.setattr(time, "time", lambda: next(ticks) * 1e-9)
            jstats = json.loads(_main_stdout(
                jcli.main, args + ["-o", str(tmp_path / f"j{sched}.ppm")], capsys))
        assert stats["epochs"] > 0
        for k in SCHED_KEYS:
            assert stats[k] == jstats[k], (sched, k)
        outs[sched] = Path(out).read_bytes()
    assert outs["ooc"] == outs["baseline"]


def test_viewer_terminal_and_interactive():
    v = InteractiveViewer(ts.cornell_box(),
                          RenderConfig(spp=1, bounces=1, integrator="pt"),
                          size=16, device="cpu")
    jv = JViewer(js.cornell_box(), JConfig(spp=1, bounces=1, integrator="pt"),
                 size=16)
    img1, jimg1 = v.frame(), jv.frame()
    img2, jimg2 = v.frame(), jv.frame()  # progressive accumulation
    v.orbit(dtheta=0.3)
    jv.orbit(dtheta=0.3)
    img3, jimg3 = v.frame(), jv.frame()
    assert img1.shape == (16, 16, 3)
    assert np.isfinite(img2).all()
    assert not np.allclose(img1, img3)  # camera moved
    for a, b in ((img1, jimg1), (img2, jimg2), (img3, jimg3)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-3, rtol=1e-3)
    buf, jbuf = io.StringIO(), io.StringIO()
    show_terminal(img1, out=buf)
    j_show_terminal(img1, out=jbuf)
    assert "\x1b[38;2" in buf.getvalue()
    assert buf.getvalue() == jbuf.getvalue()


def test_fit_albedo_recovers_and_checkpoints(tmp_path):
    """The loss falls below half in 12 steps; step 0's loss equals the
    reference's within 1e-5 and the later ones within FIT_LOSS_RTOL; 12
    steps with checkpoints, then a resume to 14, equal 14 steps in one run
    bit for bit."""
    scene, jscene = ts.cornell_box(), js.cornell_box()
    cfg = RenderConfig(spp=1, bounces=1, integrator="pt", seed=3)
    jcfg = JConfig(spp=1, bounces=1, integrator="pt", seed=3)
    cam, jcam = make_camera(**CAM), jcamera.make_camera(**CAM)
    albedo = torch.as_tensor(scene.albedo)
    target = make_diff_render_fn(scene, cam, cfg, device="cpu")(
        {"albedo": albedo}).detach()
    jtarget = j_diff_render_fn(jscene, jcam, jcfg)(
        {"albedo": jnp.asarray(jscene.albedo)})
    np.testing.assert_allclose(target.numpy(), np.asarray(jtarget), atol=2e-3,
                               rtol=1e-3)
    start = {"albedo": scene.albedo * 0.4 + 0.2}
    ckpt = str(tmp_path / "ck.npz")
    params, losses = fit(scene, cam, cfg, target, start, steps=12, lr=0.1,
                         checkpoint_path=ckpt, checkpoint_every=6, device="cpu")
    _, jlosses = j_fit(jscene, jcam, jcfg, jtarget,
                       {"albedo": jnp.asarray(start["albedo"])}, steps=12, lr=0.1)
    assert losses[-1] < losses[0] * 0.5
    assert abs(losses[0] - jlosses[0]) <= 1e-5
    np.testing.assert_allclose(losses, jlosses, rtol=FIT_LOSS_RTOL)
    step, saved, opt_state = load_checkpoint(ckpt)
    assert step == 12
    assert saved["albedo"].numpy().tobytes() == params["albedo"].numpy().tobytes()
    assert int(opt_state["albedo"]["step"]) == 12
    # resume continues from the saved step: steps 12 and 13 of 14
    params2, losses2 = fit(scene, cam, cfg, target, start, steps=14, lr=0.1,
                           checkpoint_path=ckpt, checkpoint_every=100,
                           resume=True, device="cpu")
    params14, losses14 = fit(scene, cam, cfg, target, start, steps=14, lr=0.1,
                             device="cpu")
    assert len(losses2) == 2
    assert losses14 == losses + losses2
    assert (params2["albedo"].numpy().tobytes()
            == params14["albedo"].numpy().tobytes())


def test_render_oracle_matches_reference():
    jscene = js.merge_scenes([
        js.cornell_box(),
        js.bumpy_sphere(subdiv=2, center=(0.5, 0.4, 0.4), radius=0.2)])
    scene = ts.merge_scenes([
        ts.cornell_box(),
        ts.bumpy_sphere(subdiv=2, center=(0.5, 0.4, 0.4), radius=0.2)])
    kw = dict(spp=2, bounces=2, integrator="pt", seed=5)
    img = render_oracle(scene, make_camera(**CAM), RenderConfig(**kw),
                        pixel_chunk=100, device="cpu")
    ref = np.asarray(j_render_oracle(jscene, jcamera.make_camera(**CAM),
                                     JConfig(**kw)))
    assert img.shape == (16, 16, 3) and img.mean() > 0.05
    np.testing.assert_allclose(img, ref, atol=2e-3, rtol=1e-3)


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL_KEYS = {"tris", "size", "spp", "bounces", "rays_per_frame",
                     "frame_s", "compile_s", "transfer_s", "backend",
                     "intersector", "notes"}


def test_bench_entry_prints_bench_keys():
    r = subprocess.run(
        [sys.executable, str(ROOT / "bench_torch.py"), "--device", "cpu",
         "--blobs", "2", "--tris-per-blob", "80", "--size", "16", "--spp", "1",
         "--bounces", "1", "--iters", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert BENCH_KEYS <= set(line) and BENCH_DETAIL_KEYS <= set(line["detail"])
    d = line["detail"]
    assert line["metric"] == "grays_per_sec_fwd_bwd"
    assert d["backend"] == "cpu" and d["card"] is None
    assert d["rays_per_frame"] > 0 and d["frame_s"] > 0
    assert line["value"] == d["rays_per_frame"] / d["frame_s"] / 1e9
