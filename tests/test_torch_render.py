"""The port's forward slice as a whole: spray_tpu_torch PT+NEE / AO / normal
renders (plain kernel versions on the CPU) == spray_tpu's render through
the interpret-mode Pallas kernels == the numpy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from spray_tpu.core import camera as j_camera
from spray_tpu.core.config import RenderConfig as JConfig
from spray_tpu.integrators.device import render_device as j_render_device
from spray_tpu.io import scenes as js
from spray_tpu.kernels import multidomain as jmd
from spray_tpu.oracle import render_oracle
from spray_tpu.render import default_intersector as j_default_intersector
from spray_tpu.render import make_pipeline as j_make_pipeline
from spray_tpu_torch.core.config import RenderConfig
from spray_tpu_torch.interop import camera_from_arrays, scene_from_arrays
from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector
from spray_tpu_torch.kernels.brute import PallasBruteIntersector
from spray_tpu_torch.render import default_intersector, make_pipeline, render

CAM = dict(eye=(0.5, 0.5, 2.2), lookat=(0.5, 0.5, 0.0), up=(0, 1, 0),
           fov_y_deg=40, width=16, height=16)
N_DOMAINS = 4


def _setup():
    jscene = js.merge_scenes([
        js.cornell_box(),
        js.bumpy_sphere(subdiv=2, center=(0.5, 0.4, 0.4), radius=0.2),
    ])
    jcam = j_camera.make_camera(**CAM)
    scene = scene_from_arrays(jscene.vertices, jscene.faces, jscene.albedo,
                              jscene.emission)
    cam = camera_from_arrays(jcam.eye, jcam.lower_left, jcam.du, jcam.dv,
                             jcam.width, jcam.height)
    pages = jmd.build_cluster_domains(jscene, N_DOMAINS)
    isect = MultiDomainClusterIntersector.from_pages(scene, pages, device="cpu")
    return jscene, jcam, scene, cam, isect


def _cfgs(integrator):
    kw = dict(spp=1, bounces=2, integrator=integrator, seed=5, ao_samples=4)
    return JConfig(**kw), RenderConfig(**kw)


def test_pt_nee_frame_matches_pallas_path_and_oracle():
    """PT+NEE: image and the rays-traced count equal the JAX pipeline's."""
    jscene, jcam, scene, cam, isect = _setup()
    jcfg, cfg = _cfgs("pt")
    assert cfg.nee and jcfg.nee
    jisect = jmd.MultiDomainClusterIntersector(jscene, n_domains=N_DOMAINS,
                                               interpret=True)
    jpipe = j_make_pipeline(jscene, jcam, jcfg, intersector=jisect)
    jimg, jrays = jpipe.run()
    pipe = make_pipeline(scene, cam, cfg, intersector=isect, device="cpu")
    out = pipe.run()
    img = out[0].numpy()
    assert pipe.rays_traced(out) == int(jpipe.rays_traced((jimg, jrays)))
    np.testing.assert_allclose(img, np.asarray(jimg), atol=2e-3, rtol=1e-3)
    ref = np.asarray(render_oracle(jscene, jcam, jcfg))
    np.testing.assert_allclose(img, ref, atol=2e-3, rtol=1e-3)
    assert img.mean() > 0.05  # the frame is lit, not trivially equal


@pytest.mark.parametrize("integrator", ["ao", "normal"])
def test_ao_and_normal_frames_match(integrator):
    jscene, jcam, scene, cam, isect = _setup()
    jcfg, cfg = _cfgs(integrator)
    img = render(scene, cam, cfg, intersector=isect, device="cpu")
    jisect = jmd.MultiDomainClusterIntersector(jscene, n_domains=N_DOMAINS,
                                               interpret=True)
    ref = np.asarray(j_render_device(jscene, jcam, jcfg, intersector=jisect))
    np.testing.assert_allclose(img, ref, atol=2e-3, rtol=1e-3)
    orc = np.asarray(render_oracle(jscene, jcam, jcfg))
    np.testing.assert_allclose(img, orc, atol=2e-3, rtol=1e-3)


def test_spp_batched_accumulation_deterministic():
    """spp samples of a pixel are adjacent and summed by a reshape, never a
    scatter-add: two runs give the same bits."""
    _, _, scene, cam, isect = _setup()
    cfg = RenderConfig(spp=3, bounces=1, integrator="pt", seed=2)
    a = render(scene, cam, cfg, intersector=isect, device="cpu")
    b = render(scene, cam, cfg, intersector=isect, device="cpu")
    assert a.tobytes() == b.tobytes()
    assert np.isfinite(a).all() and a.mean() > 0


@pytest.mark.parametrize("prefer", ["auto", "brute", "binned", "sweep",
                                    "pallas", "multidomain"])
def test_default_intersector_picks_the_reference_class(prefer):
    """Same class name as the reference's selector for every `prefer`, on a
    scene above the 256-triangle brute threshold and (auto) below it: off
    its card, as off the reference's TPU, "auto" above it is the stackful
    BVHIntersector (on the card the multi-domain cluster intersector,
    checked by chip_smoke.py)."""
    jscene, _, scene, _, _ = _setup()
    assert scene.num_faces > 256
    got = default_intersector(scene, prefer=prefer, device="cpu")
    want = type(j_default_intersector(jscene, prefer=prefer)).__name__
    if prefer == "auto":
        assert want == "BVHIntersector"
    assert type(got).__name__ == want
    if prefer == "auto":
        small = default_intersector(js.cornell_box(), device="cpu")
        assert type(small).__name__ == type(
            j_default_intersector(js.cornell_box())).__name__ == "BruteIntersector"
    with pytest.raises(ValueError, match="prefer"):
        default_intersector(scene, prefer="embree", device="cpu")


@pytest.fixture(scope="module")
def cornell32():
    """A 32x32 Cornell PT+NEE frame through the multi-domain intersector."""
    from spray_tpu_torch.core.camera import make_camera
    from spray_tpu_torch.io.scenes import cornell_box

    scene = cornell_box()
    cam = make_camera(**{**CAM, "width": 32, "height": 32})
    cfg = RenderConfig(spp=1, bounces=2, integrator="pt", seed=5)
    base = render(scene, cam, cfg, device="cpu",
                  intersector=MultiDomainClusterIntersector(scene, device="cpu"))
    return scene, cam, cfg, base


@pytest.mark.parametrize("which", ["binned", "sweep", "brute_kernels"])
def test_alternate_intersectors_render_the_same_frame(cornell32, which):
    scene, cam, cfg, base = cornell32
    if which == "brute_kernels":
        isect = PallasBruteIntersector(scene, device="cpu")
    else:
        isect = default_intersector(scene, prefer=which, device="cpu")
    img = render(scene, cam, cfg, intersector=isect, device="cpu")
    np.testing.assert_allclose(img, base, atol=2e-3, rtol=1e-3)
    assert base.mean() > 0.05
