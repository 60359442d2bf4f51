"""The port's differentiable path (torch autograd over the plain kernel
versions on the CPU) == spray_tpu's `make_diff_render_fn` (jax.grad, Pallas
in interpret mode): loss and albedo / vertex / emission gradients to 1e-4 on
the scenes of tests/test_diff.py and tests/test_diff_tight.py; the
training step `make_pipeline(backward=True)`; and a host-driven frame
through the out-of-core scheduler.  The scene-only inputs that
`scene_consts` holds give the arrays, losses and gradients of a rebuild in
every step bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.core import camera as j_camera
from spray_tpu.core.config import RenderConfig as JConfig
from spray_tpu.diff import make_diff_render_fn as j_make_diff
from spray_tpu.integrators.device import render_device as j_render_device
from spray_tpu.io import scenes as js
from spray_tpu.kernels import multidomain as jmd
from spray_tpu.kernels.traverse import ClusterBVHIntersector as JCluster
from spray_tpu.oracle.brute import BruteIntersector as JBrute
from spray_tpu.render import make_pipeline as j_make_pipeline
from spray_tpu.sched.epochs import OOCIntersector as JOOC
from spray_tpu_torch import diff as tdiff
from spray_tpu_torch.core import geom
from spray_tpu_torch.core.camera import make_camera
from spray_tpu_torch.core.config import RenderConfig
from spray_tpu_torch.diff import grads_of, make_diff_render_fn, render_grad
from spray_tpu_torch.integrators import wavefront
from spray_tpu_torch.integrators.device import render_device
from spray_tpu_torch.interop import camera_from_arrays, scene_from_arrays
from spray_tpu_torch.io.scenes import wisp_cloud
from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector
from spray_tpu_torch.kernels.traverse import ClusterBVHIntersector
from spray_tpu_torch.oracle.brute import BruteIntersector
from spray_tpu_torch.render import make_pipeline
from spray_tpu_torch.sched.epochs import OOCIntersector

W = (0.4, 0.8, 1.3)  # the asymmetric loss weights of the reference's tests
CAM24 = dict(eye=(0.5, 0.5, 2.2), lookat=(0.5, 0.5, 0.0), up=(0, 1, 0),
             fov_y_deg=40, width=24, height=24)
CAM_TIGHT = dict(eye=(0.0, 0.2, 2.2), lookat=(0.0, 0.0, 0.0), up=(0, 1, 0),
                 fov_y_deg=40, width=16, height=16)


def _lit_spheres(subdiv):
    return js.merge_scenes([
        js.cornell_box(),
        js.icosphere(subdiv=subdiv, center=(0.5, 0.35, 0.35), radius=0.18),
    ])


def _brute(jscene):
    return JBrute(jscene, jnp), lambda s: BruteIntersector(s, device="cpu",
                                                           budget=1 << 22)


def _cluster(jscene):
    jx = JCluster(jscene, interpret=True)
    return jx, lambda s: ClusterBVHIntersector(s, cbvh=jx.host, device="cpu")


# name: (scene, camera, config, params, intersectors); tests/test_diff.py
# then tests/test_diff_tight.py
CASES = {
    "pt_albedo": (js.cornell_box, CAM24,
                  dict(spp=1, bounces=2, integrator="pt", seed=11),
                  ("albedo",), _brute),
    "ao_vertices_zero": (
        lambda: js.icosphere(subdiv=2, center=(0.5, 0.5, 0.3), radius=0.25),
        CAM24, dict(spp=1, integrator="ao", ao_samples=2, seed=4),
        ("vertices",), _brute),
    "pt_nee_vertices": (lambda: _lit_spheres(1), CAM24,
                        dict(spp=1, bounces=1, integrator="pt", nee=True,
                             seed=4), ("vertices",), _brute),
    "pt_emission": (js.cornell_box, CAM24,
                    dict(spp=1, bounces=1, integrator="pt", seed=0),
                    ("emission",), _brute),
    "tight_ao_albedo_82k": (
        lambda: js.bumpy_sphere(subdiv=6, center=(0.0, 0.0, 0.0), radius=0.8,
                                seed=2),
        CAM_TIGHT, dict(spp=1, integrator="ao", ao_samples=2, seed=7),
        ("albedo",), _brute),
    "tight_vertices_brute": (lambda: _lit_spheres(2), CAM24,
                             dict(spp=1, bounces=1, integrator="pt", nee=True,
                                  seed=4), ("vertices", "albedo"), _brute),
    "tight_vertices_cluster": (lambda: _lit_spheres(2), CAM24,
                               dict(spp=1, bounces=1, integrator="pt",
                                    nee=True, seed=4), ("vertices", "albedo"),
                               _cluster),
}


def _port_inputs(jscene, jcam):
    scene = scene_from_arrays(jscene.vertices, jscene.faces, jscene.albedo,
                              jscene.emission)
    cam = camera_from_arrays(jcam.eye, jcam.lower_left, jcam.du, jcam.dv,
                             jcam.width, jcam.height)
    return scene, cam


def _both(name, spp_batch=True, spp=None):
    make, cam_kw, cfg_kw, keys, isects = CASES[name]
    if spp is not None:
        cfg_kw = {**cfg_kw, "spp": spp}
    jscene = make()
    jcam = j_camera.make_camera(**cam_kw)
    jx, make_port = isects(jscene)
    jrender = j_make_diff(jscene, jcam, JConfig(**cfg_kw),
                          make_intersector=lambda s: jx, spp_batch=spp_batch)
    w = jnp.asarray(W, jnp.float32)
    jparams = {k: jnp.asarray(getattr(jscene, k)) for k in keys}
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean(jrender(p) * w)))(jparams)
    scene, cam = _port_inputs(jscene, jcam)
    render = make_diff_render_fn(scene, cam, RenderConfig(**cfg_kw),
                                 make_intersector=make_port,
                                 spp_batch=spp_batch, device="cpu")
    params = {k: torch.tensor(getattr(jscene, k), requires_grad=True)
              for k in keys}
    lt = torch.mean(render(params) * torch.tensor(W))
    gt = grads_of(lt, params)
    return (float(lj), {k: np.asarray(v) for k, v in gj.items()},
            float(lt.detach()), {k: v.numpy() for k, v in gt.items()})


def _assert_grads_match(lj, gj, lt, gt):
    assert abs(lt - lj) <= 1e-4 * max(1.0, abs(lj))
    for k, g in gt.items():
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, gj[k], rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradients_match_reference(name):
    lj, gj, lt, gt = _both(name)
    _assert_grads_match(lj, gj, lt, gt)
    for k, g in gt.items():
        if name == "ao_vertices_zero":
            # AO is pure visibility: with detached visibility the vertex
            # gradient is exactly zero, as in the reference
            np.testing.assert_array_equal(g, 0)
        else:
            assert np.abs(g).max() > 1e-4, k


def test_per_sample_form_matches_reference():
    """spp_batch=False (one wavefront per sample) at spp 2."""
    lj, gj, lt, gt = _both("pt_albedo", spp_batch=False, spp=2)
    _assert_grads_match(lj, gj, lt, gt)
    lb, _, _, gb = _both("pt_albedo", spp_batch=True, spp=2)
    np.testing.assert_allclose(gb["albedo"], gt["albedo"], rtol=0, atol=1e-6)


def test_render_grad_default_loss():
    jscene = js.cornell_box()
    scene, cam = _port_inputs(jscene, j_camera.make_camera(**CAM24))
    cfg = RenderConfig(spp=1, bounces=1, integrator="pt", seed=3)
    loss, grads = render_grad(scene, cam, cfg,
                              {"albedo": torch.tensor(jscene.albedo)},
                              device="cpu")
    render = make_diff_render_fn(scene, cam, cfg, device="cpu")
    assert float(loss) == float(render({}).mean())
    assert grads["albedo"].shape == jscene.albedo.shape
    assert torch.isfinite(grads["albedo"]).all() and grads["albedo"].abs().max() > 0


def _frame_setup():
    jscene = js.merge_scenes([
        js.cornell_box(),
        js.bumpy_sphere(subdiv=2, center=(0.5, 0.4, 0.4), radius=0.2),
    ])
    jcam = j_camera.make_camera(**{**CAM24, "width": 16, "height": 16})
    return jscene, jcam, *_port_inputs(jscene, jcam)


def test_training_step_matches_reference_pipeline():
    """make_pipeline(backward=True) through the multi-domain intersector at
    16x16: loss, vertex and albedo gradients, and rays traced."""
    jscene, jcam, scene, cam = _frame_setup()
    kw = dict(spp=1, bounces=2, integrator="pt", seed=5)
    jisect = jmd.MultiDomainClusterIntersector(jscene, n_domains=4,
                                               interpret=True)
    jpipe = j_make_pipeline(jscene, jcam, JConfig(**kw), backward=True,
                            intersector=jisect)
    jout = jpipe.run()
    isect = MultiDomainClusterIntersector.from_pages(
        scene, jmd.build_cluster_domains(jscene, 4), device="cpu")
    pipe = make_pipeline(scene, cam, RenderConfig(**kw), backward=True,
                         intersector=isect, device="cpu")
    out = pipe.run()
    assert pipe.rays_traced(out) == int(jpipe.rays_traced(jout))
    _assert_grads_match(float(jout[0]), {k: np.asarray(v) for k, v in
                                         jout[1].items()},
                        float(out[0]), {k: v.numpy() for k, v in
                                        out[1].items()})
    assert set(out[1]) == {"vertices", "albedo"}
    assert all(np.abs(g.numpy()).max() > 0 for g in out[1].values())


def test_host_driven_frame_through_ooc_matches_reference():
    """render_device with the out-of-core scheduler (host-driven: one eager
    wavefront per sample) == the reference's at 16x16."""
    jscene, jcam, scene, cam = _frame_setup()
    kw = dict(spp=1, bounces=2, integrator="pt", seed=5)
    jx = JOOC(jscene, n_domains=4, num_slots=2, speculate=True,
              backend="cluster", interpret=True, lookahead=False)
    ref = np.asarray(j_render_device(jscene, jcam, JConfig(**kw),
                                     intersector=jx))
    ooc = OOCIntersector(scene, n_domains=4, num_slots=2, speculate=True,
                         lookahead=False, backend="cluster", device="cpu")
    img = render_device(scene, cam, RenderConfig(**kw), intersector=ooc,
                        device="cpu")
    np.testing.assert_allclose(img, ref, atol=2e-3, rtol=1e-3)
    assert img.mean() > 0.05
    assert ooc.stats.epochs == jx.stats.epochs
    assert ooc.stats.committed == jx.stats.committed


class _GrazingIntersector:
    """Brute hits, except that the first alive lane that misses comes back as
    a hit of prim 0 at t 1: a hit the Möller–Trumbore recompute rejects, as
    a kernel's grazing edge hit at f32 rounding can be."""

    def __init__(self, scene):
        self.inner = BruteIntersector(scene, device="cpu")
        self.forced = 0

    def intersect(self, o, d, tmin, tmax):
        h = self.inner.intersect(o, d, tmin, tmax)
        lanes = torch.nonzero(~h.valid & (tmax > 0)).view(-1)
        if not lanes.numel():
            return h
        i = lanes[0]
        self.forced += 1
        valid, prim, t = h.valid.clone(), h.prim.clone(), h.t.clone()
        valid[i], prim[i], t[i] = True, 0, 1.0
        return type(h)(t=t, prim=prim, u=h.u, v=h.v, valid=valid)

    def occluded(self, o, d, tmax):
        return self.inner.occluded(o, d, tmax)


def test_rejected_hit_keeps_gradients_finite():
    """A hit the recompute rejects takes the intersector's t, not the
    infinite window, so the shading point stays finite and no NaN reaches
    the gradients through masked lanes."""
    jscene = js.cornell_box()
    scene, cam = _port_inputs(jscene, j_camera.make_camera(**CAM24))
    grazing = _GrazingIntersector(scene)
    render = make_diff_render_fn(
        scene, cam, RenderConfig(spp=1, bounces=2, integrator="pt", seed=11),
        make_intersector=lambda s: grazing, device="cpu")
    params = {k: torch.tensor(getattr(jscene, k), requires_grad=True)
              for k in ("vertices", "albedo")}
    loss = torch.mean(render(params) * torch.tensor(W))
    grads = grads_of(loss, params)
    assert grazing.forced > 0
    assert torch.isfinite(loss)
    for k, g in grads.items():
        assert torch.isfinite(g).all(), k
        assert g.abs().max() > 0, k


WISP = wisp_cloud(n_blobs=8, tris_per_blob=80, extent=4.0, seed=5)


def _rebuilt_arrays(scene, params, consts):
    """`diff_scene_arrays` as it was before `scene_consts` held the
    scene-only inputs: the offset epsilon and the light ids from the host
    arrays in every call."""
    faces = consts["faces"]
    device = faces.device
    vertices = params.get("vertices")
    if vertices is None:
        vertices = torch.as_tensor(np.asarray(scene.vertices, np.float32),
                                   device=device)
    albedo = params.get("albedo")
    if albedo is None:
        albedo = torch.as_tensor(np.asarray(scene.albedo, np.float32),
                                 device=device)
    emission = params.get("emission", consts["emission"])
    arrays = {
        "albedo": albedo,
        "emission": emission,
        "normals": geom.face_normals(vertices, faces),
        "offset_eps": wavefront.scene_offset_eps(scene),
        "lights": wavefront.make_light_arrays(
            vertices, faces, emission, wavefront.light_ids_static(scene)),
    }
    return arrays, vertices, faces


def test_scene_consts_hold_the_scene_only_inputs():
    consts = tdiff.scene_consts(WISP, "cpu")
    eps = consts["offset_eps"]
    assert eps.dtype == np.float32 and eps == wavefront.scene_offset_eps(WISP)
    ids = consts["light_ids"]
    want = wavefront.light_ids_static(WISP)
    assert isinstance(ids, torch.Tensor) and ids.device.type == "cpu"
    assert ids.dtype == torch.int64 and len(want) > 0
    assert np.array_equal(ids.numpy(), want)
    # the ids are taken as they are: no copy
    assert torch.as_tensor(ids, device=ids.device) is ids


@pytest.mark.parametrize("keys", [(), ("vertices", "albedo"),
                                  ("vertices", "albedo", "emission")])
def test_scene_arrays_equal_a_rebuild_in_every_call(keys):
    consts = tdiff.scene_consts(WISP, "cpu")
    params = {k: torch.tensor(getattr(WISP, k), requires_grad=True)
              for k in keys}
    got, gv, gf = tdiff.diff_scene_arrays(WISP, params, consts)
    want, wv, wf = _rebuilt_arrays(WISP, params, consts)
    assert got.keys() == want.keys() and got["lights"].keys() == \
        want["lights"].keys()
    assert got["offset_eps"] == want["offset_eps"]
    for k in ("albedo", "emission", "normals"):
        assert got[k].numpy(force=True).tobytes() == \
            want[k].numpy(force=True).tobytes(), k
    for k, v in want["lights"].items():
        assert got["lights"][k].numpy(force=True).tobytes() == \
            v.numpy(force=True).tobytes(), k
    assert torch.equal(gv, wv) and gf is wf
    if "vertices" in keys:  # gradients still reach the light geometry
        assert got["lights"]["area"].requires_grad


def test_training_steps_equal_a_rebuild_in_every_step(monkeypatch):
    """Two steps of make_pipeline(backward=True) on a small wisp_cloud give
    the loss and gradients of the per-step rebuild bit for bit."""
    cam = make_camera(eye=(7.0, 5.0, 9.0), lookat=(0.0, 0.0, 0.0),
                      up=(0, 1, 0), fov_y_deg=45, width=12, height=12)
    cfg = RenderConfig(width=12, height=12, spp=2, bounces=2, seed=11)

    def two_steps():
        isect = MultiDomainClusterIntersector(WISP, n_domains=4,
                                              device="cpu")
        pipe = make_pipeline(WISP, cam, cfg, backward=True, intersector=isect,
                             device="cpu")
        return [pipe.run() for _ in range(2)]

    got = two_steps()
    with monkeypatch.context() as mp:
        mp.setattr(tdiff, "diff_scene_arrays", _rebuilt_arrays)
        want = two_steps()
    for (gl, gg, gn), (wl, wg, wn) in zip(got, want):
        assert gl.numpy().tobytes() == wl.numpy().tobytes()
        assert gg.keys() == wg.keys() == {"vertices", "albedo"}
        for k in gg:
            assert gg[k].numpy().tobytes() == wg[k].numpy().tobytes(), k
        assert int(gn) == int(wn)
    assert float(got[0][0]) > 0
    assert all(g.abs().max() > 0 for g in got[0][1].values())
