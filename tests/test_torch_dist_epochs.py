"""The port's in-situ epoch renderer in 4 gloo ranks (domains owned per
rank, rays exchanged in bucketed all-to-all epochs, the cluster kernels'
plain versions as the local trace) == the single-process renderer and the
reference's on a 4-device mesh: counterparts of the five cases of
tests/test_dist_epochs.py on its scene, configurations and tolerances, its
counters == the reference's, and its differentiable step's loss and
gradients == the reference's make_insitu_diff_fn."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from spray_tpu.core.camera import make_camera as j_camera
from spray_tpu.dist.epochs import make_insitu_diff_fn as j_insitu_diff
from spray_tpu.dist.epochs import make_insitu_renderer as j_insitu
from spray_tpu.dist.rayshard import make_mesh as j_mesh
from spray_tpu.io.scenes import wisp_cloud as j_wisp
from spray_tpu_torch.core.camera import make_camera
from spray_tpu_torch.diff import make_diff_render_fn
from spray_tpu_torch.dist.launch import run_world
from spray_tpu_torch.integrators.device import render_device
from spray_tpu_torch.io.scenes import wisp_cloud

WORLD = 4
SCENE = wisp_cloud(**W.EPOCHS_SCENE)
CAM = make_camera(**W.EPOCHS_CAM)


@pytest.fixture(scope="module")
def port():
    """Rank 0's results; every rank returns the same gathered images."""
    ranks = run_world(W.epochs_rank, WORLD, device="cpu")
    for r in ranks[1:]:
        for name in W.EPOCHS_CASES:
            np.testing.assert_array_equal(r[name]["img"], ranks[0][name]["img"])
    return ranks[0]


def _single(name):
    return render_device(SCENE, CAM, W.EPOCHS_CASES[name][0], device="cpu")


@functools.cache
def _reference(name):
    """The reference's image and last_stats on a 4-device mesh."""
    cfg, kw = W.EPOCHS_CASES[name]
    render = j_insitu(j_wisp(**W.EPOCHS_SCENE), j_camera(**W.EPOCHS_CAM), cfg,
                      j_mesh(WORLD), **kw)
    return render(), render.last_stats


def _assert_matches_reference(port, name):
    """The port's image within the single-device bar of the reference's at
    the same world size and bucket, and its counters equal."""
    img_j, stats_j = _reference(name)
    np.testing.assert_allclose(port[name]["img"], img_j, atol=2e-3, rtol=1e-3)
    assert port[name]["stats"] == stats_j


def test_insitu_distributed_matches_single_device(port):
    img = port["single"]["img"]
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, _single("single"), atol=2e-3, rtol=1e-3)
    _assert_matches_reference(port, "single")


def test_insitu_small_bucket_still_converges(port):
    """Bucket overflow spills rays to later epochs without changing
    results; the epochs, rays exchanged and activations are the
    reference's at the same world size and bucket."""
    np.testing.assert_allclose(port["small_bucket"]["img"],
                               _single("small_bucket"), atol=2e-3, rtol=1e-3)
    _assert_matches_reference(port, "small_bucket")
    epochs = port["small_bucket"]["stats"]["epochs"]
    assert epochs > 2 * (W.EPOCHS_CASES["small_bucket"][0].bounces + 1)


def test_insitu_cluster_and_jnp_backends_agree(port):
    ref = _single("cluster")
    np.testing.assert_allclose(port["cluster"]["img"], ref, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(port["jnp"]["img"], ref, atol=2e-3, rtol=1e-3)
    _assert_matches_reference(port, "cluster")
    _assert_matches_reference(port, "jnp")


def test_insitu_diff_matches_single_device_grads(port):
    """Backward through the 64-domain in-situ renderer: vertex and albedo
    grads all-reduced over 4 ranks == the single-process
    detached-visibility gradients and the reference's make_insitu_diff_fn
    on a 4-device mesh (loss rtol 1e-5; grads atol 1e-5 of their largest,
    rtol 1e-4)."""
    render = make_diff_render_fn(SCENE, CAM, W.DIFF_CFG, device="cpu")
    w = torch.tensor([0.4, 0.8, 1.3])
    params = {k: v.requires_grad_(True) for k, v in W.scene_params(SCENE).items()}
    loss_r = torch.mean(render(params) * w)
    grads_r = torch.autograd.grad(loss_r, list(params.values()))
    j_scene = j_wisp(**W.EPOCHS_SCENE)
    j_step = j_insitu_diff(j_scene, j_camera(**W.EPOCHS_CAM), W.DIFF_CFG,
                           j_mesh(WORLD), **W.DIFF_KW)
    loss_j, grads_j = j_step({k: jnp.asarray(getattr(j_scene, k))
                              for k in params})
    refs = {"port single process": (float(loss_r.detach()),
                                    {k: g.numpy() for k, g in zip(params, grads_r)}),
            "reference": (float(loss_j),
                          {k: np.asarray(grads_j[k]) for k in params})}
    d = port["diff"]
    for label, (loss, grads) in refs.items():
        np.testing.assert_allclose(d["loss"], loss, rtol=1e-5, err_msg=label)
        for k, gr in grads.items():
            gd = d[k]
            assert np.isfinite(gd).all()
            scale = np.abs(gr).max()
            assert scale > 0
            np.testing.assert_allclose(gd, gr, atol=1e-5 * scale, rtol=1e-4,
                                       err_msg=f"{label} {k}")


def test_insitu_stats_and_rounds_per_check(port):
    """The counters are populated and equal the reference's on a 4-device
    mesh; rounds_per_check=2 reproduces the image and rays_exchanged with
    fewer host syncs (one read of the global count per two rounds)."""
    s, s2 = port["stats"], port["stats_k2"]
    assert s["stats"]["epochs"] > 0
    assert s["stats"]["rays_exchanged"] > 0
    assert s["stats"]["trace_activations"] > 0
    np.testing.assert_allclose(s2["img"], s["img"], atol=1e-6, rtol=1e-6)
    assert s2["stats"]["rays_exchanged"] == s["stats"]["rays_exchanged"]
    calls = 2 * W.EPOCHS_CASES["stats"][0].bounces + 1  # intersect, occluded
    syncs, syncs2 = s["collectives"]["host_syncs"], s2["collectives"]["host_syncs"]
    assert syncs == calls + s["stats"]["epochs"]  # a prime, then one a round
    assert syncs2 < syncs
    # one forward and one inverse exchange and one liveness reduce a round,
    # one reduce to prime each call, and the activations' sum
    c = s["collectives"]
    assert c["all_to_all"] == 2 * s["stats"]["epochs"]
    assert c["all_reduce"] == s["stats"]["epochs"] + calls + 1
    assert c["all_gather"] == 1
    _assert_matches_reference(port, "stats")
    np.testing.assert_allclose(s["img"], _single("stats"), atol=2e-3, rtol=1e-3)
