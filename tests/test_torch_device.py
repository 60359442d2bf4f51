"""make_render_fn takes the batched form when its wavefront fits in the
device's free memory, else the per-sample form, one wavefront per sample.
The per-sample form == spray_tpu's per-sample frame (spp_batch=False, its
lax.scan over samples) and == the port's batched frame: the case of
tests/test_oracle_parity.py::test_spp_batched_equals_scanned.  The free
memory is patched to pick each form.  A host-driven frame builds the
scene's arrays once for a scene object and device
(`wavefront.scene_arrays_for`) and gives the image of arrays built afresh
in every frame."""

import dataclasses
import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spray_tpu.core import camera as j_camera
from spray_tpu.core.config import RenderConfig as JConfig
from spray_tpu.integrators import device as jdev
from spray_tpu.io import scenes as js
from spray_tpu_torch import trace
from spray_tpu_torch.core.camera import make_camera
from spray_tpu_torch.core.config import RenderConfig
from spray_tpu_torch.core.device import free_bytes
from spray_tpu_torch.integrators import device as tdev
from spray_tpu_torch.integrators import wavefront
from spray_tpu_torch.integrators.device import make_render_fn
from spray_tpu_torch.integrators.wavefront import make_scene_arrays
from spray_tpu_torch.interop import camera_from_arrays, scene_from_arrays
from spray_tpu_torch.io.scenes import wisp_cloud
from spray_tpu_torch.oracle.brute import BruteIntersector
from spray_tpu_torch.sched.epochs import OOCIntersector

CAM = dict(eye=(0.5, 0.5, 2.2), lookat=(0.5, 0.5, 0.0), up=(0, 1, 0),
           fov_y_deg=40, width=48, height=48)
CFG = dict(width=48, height=48, spp=3, bounces=2, integrator="pt", seed=7)


NEED = 48 * 48 * 3 * tdev.RAY_BYTES  # the batched wavefront's bytes


def _frame(scene, cam, cfg, isect, arrays, free):
    """make_render_fn with `free` bytes free: (its form, image, rays)."""
    saved = tdev.free_bytes
    tdev.free_bytes = lambda device: free
    try:
        fn = make_render_fn(scene, cam, cfg, isect, with_stats=True,
                            device="cpu")
    finally:
        tdev.free_bytes = saved
    return (fn.spp_batch, *fn(arrays))


@pytest.fixture(scope="module")
def frames():
    jscene, jcam, jcfg = js.cornell_box(), j_camera.make_camera(**CAM), JConfig(**CFG)
    ref = jdev.make_render_fn(jscene, jcam, jcfg, with_stats=True,
                              spp_batch=False)(jdev.device_scene_arrays(jscene))
    scene = scene_from_arrays(jscene.vertices, jscene.faces, jscene.albedo,
                              jscene.emission)
    cam = camera_from_arrays(jcam.eye, jcam.lower_left, jcam.du, jcam.dv,
                             jcam.width, jcam.height)
    cfg = RenderConfig(**CFG)
    isect = BruteIntersector(scene, device="cpu")
    arrays = make_scene_arrays(scene, "cpu")
    out = {}
    for free in (0, 2 * NEED):
        batch, img, rays = _frame(scene, cam, cfg, isect, arrays, free)
        out[batch] = img, rays
    assert set(out) == {False, True}
    return ref, out, (scene, cam, cfg, isect, arrays)


def test_per_sample_frame_matches_reference_per_sample_frame(frames):
    (jimg, jrays), out, _ = frames
    img, rays = out[False]
    assert img.shape == (48, 48, 3) and bool(img.isfinite().all())
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=2e-3,
                               rtol=1e-3)
    assert int(rays) == int(jrays)
    assert float(img.mean()) > 0.05


def test_per_sample_frame_equals_batched_frame(frames):
    _, out, _ = frames
    (a, ra), (b, rb) = out[True], out[False]
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=1e-6)
    assert int(ra) == int(rb) > 48 * 48 * 3


@pytest.mark.parametrize("spare", [0, -1])
def test_form_chosen_by_free_memory(frames, spare):
    """With exactly the batched wavefront's bytes free the batched form is
    taken; a byte short of them, the per-sample form.  Each gives that
    form's image and rays bit for bit."""
    _, out, inputs = frames
    batch, img, rays = _frame(*inputs, NEED + spare)
    assert batch is (spare == 0)
    want, want_rays = out[batch]
    assert img.numpy().tobytes() == want.numpy().tobytes()
    assert int(rays) == int(want_rays)


@pytest.mark.parametrize("chunk", [None, 500])
def test_eager_render_equals_per_sample_frame(frames, chunk):
    """wavefront.render (the scheduler's and the oracle's loop), whole or
    cut into wavefronts of 500 pixels, sums each pixel's samples in the
    per-sample frame's order: the same image bit for bit."""
    _, out, (scene, cam, cfg, isect, _) = frames
    img = wavefront.render(scene, cam, cfg, isect, "cpu", pixel_chunk=chunk)
    assert img.numpy().tobytes() == out[False][0].numpy().tobytes()


def test_free_bytes_of_the_host():
    assert free_bytes("cpu") > 0


OOC_CAM = make_camera(eye=(7.0, 5.0, 9.0), lookat=(0.0, 0.0, 0.0),
                      up=(0, 1, 0), fov_y_deg=45, width=12, height=12)
OOC_CFG = RenderConfig(width=12, height=12, spp=2, bounces=2, seed=11)


def _wisp():
    return wisp_cloud(n_blobs=8, tris_per_blob=80, extent=4.0, seed=5)


def _ooc(scene):
    return OOCIntersector(scene, n_domains=4, num_slots=2, lookahead=False,
                          backend="cluster", device="cpu")


def _traced_frame(scene, isect):
    """render_device's host-driven frame under a profiler: (image, the
    window's scene_builds)."""
    with profile(activities=[ProfilerActivity.CPU]):
        img = tdev.render_device(scene, OOC_CAM, OOC_CFG, intersector=isect,
                                 device="cpu")
    return img, trace.read().get("scene_builds")


def _fresh_frame(scene, isect, monkeypatch):
    """The frame with the scene's arrays built afresh for it."""
    with monkeypatch.context() as mp:
        mp.setattr(wavefront, "scene_arrays_for", make_scene_arrays)
        return tdev.render_device(scene, OOC_CAM, OOC_CFG, intersector=isect,
                                  device="cpu")


def test_host_driven_frames_build_the_scene_arrays_once(monkeypatch):
    scene = _wisp()
    isect = _ooc(scene)
    img1, n1 = _traced_frame(scene, isect)
    held = wavefront._held[2]
    img2, n2 = _traced_frame(scene, isect)
    assert (n1, n2) == (1, 0)
    assert wavefront._held[2] is held and wavefront._held[0]() is scene
    want = _fresh_frame(scene, isect, monkeypatch)
    assert img1.tobytes() == img2.tobytes() == want.tobytes()
    assert img1.mean() > 0


def test_a_replaced_scene_builds_anew_and_renders_its_albedo(monkeypatch):
    scene = _wisp()
    isect = _ooc(scene)
    old, _ = _traced_frame(scene, isect)
    bright = dataclasses.replace(
        scene, albedo=np.clip(np.asarray(scene.albedo) * 1.1, 0.0, 1.0))
    img, n = _traced_frame(bright, isect)
    assert n == 1 and wavefront._held[0]() is bright
    assert img.tobytes() == _fresh_frame(bright, isect, monkeypatch).tobytes()
    assert img.tobytes() != old.tobytes()


def test_a_collected_scene_lets_its_arrays_go():
    scene = _wisp()
    isect = _ooc(scene)
    tdev.render_device(scene, OOC_CAM, OOC_CFG, intersector=isect,
                       device="cpu")
    assert wavefront._held[0]() is scene
    del scene, isect
    gc.collect()
    assert wavefront._held is None
    # a device other than the held one builds anew too
    scene = _wisp()
    a = wavefront.scene_arrays_for(scene, "cpu")
    assert wavefront.scene_arrays_for(scene, torch.device("cpu")) is a
    assert wavefront.scene_arrays_for(scene, "meta") is not a
    assert wavefront._held[1] == torch.device("meta")
