"""The port's ray-sharded renderer in 4 gloo ranks == its single-process
renderer and spray_tpu's sharded renderer: counterparts of
tests/test_dist_rayshard.py, and the multi-rank dry run against the
reference's recorded line (MULTICHIP_r05.json).  Changing where rays live
must never change the image."""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist_worker as W
from spray_tpu.core.camera import make_camera as j_camera
from spray_tpu.dist import rayshard as jrs
from spray_tpu.io.scenes import cornell_box as j_cornell
from spray_tpu_torch.core.camera import make_camera
from spray_tpu_torch.diff import render_grad
from spray_tpu_torch.dist.dryrun import dryrun_multichip
from spray_tpu_torch.dist.launch import run_world
from spray_tpu_torch.integrators.device import render_device
from spray_tpu_torch.io.scenes import cornell_box

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    return run_world(W.rayshard_rank, WORLD, device="cpu")


def test_sharded_forward_matches_single_device(ranks):
    scene, cam = cornell_box(), make_camera(**W.RAYSHARD_CAM)
    single = render_device(scene, cam, W.RAYSHARD_FWD, device="cpu")
    for r in ranks:  # the gathered image, the same on every rank
        np.testing.assert_allclose(r["img"], single, atol=1e-5, rtol=1e-5)


def test_sharded_grads_match_single_device_and_reference(ranks):
    """The loss and albedo gradient summed over 4 ranks == the port's
    single-process step and the reference's 4-device sharded step (loss
    rtol 1e-5, gradients rtol 1e-4); one all_reduce for the gradient and
    one for the loss."""
    scene, cam = cornell_box(), make_camera(**W.RAYSHARD_CAM)
    npix = cam.width * cam.height
    w = torch.tensor([0.4, 0.8, 1.3])
    loss_s, grads_s = render_grad(
        scene, cam, W.RAYSHARD_GRAD,
        {"albedo": torch.as_tensor(scene.albedo)},
        loss_fn=lambda im: torch.sum(im * w) / (npix * 3), device="cpu")

    jscene, jcam = j_cornell(), j_camera(**W.RAYSHARD_CAM)
    mesh = jrs.make_mesh(WORLD)
    step = jrs.make_sharded_render_grad(jscene, jcam, W.RAYSHARD_GRAD, mesh)
    ids, _ = jrs.padded_pixel_ids(jcam, WORLD)
    ids_dev = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, P("dev")))
    _, loss_j, grads_j = step({"albedo": jnp.asarray(jscene.albedo)}, ids_dev)

    for r in ranks:
        for ref_loss, ref_g in ((float(loss_s), grads_s["albedo"].numpy()),
                                (float(loss_j), np.asarray(grads_j["albedo"]))):
            np.testing.assert_allclose(r["loss"], ref_loss, rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(r["albedo"], ref_g, rtol=1e-4, atol=1e-7)
        assert r["collectives"] == {"all_reduce": 2, "all_to_all": 0,
                                    "all_gather": 0, "host_syncs": 0}
        assert np.isfinite(r["shard"]).all() and r["shard"].shape == (npix // WORLD, 3)
    # each rank's shard is its contiguous band of the single-device image
    img = np.concatenate([r["shard"] for r in ranks])
    single = render_device(scene, cam, W.RAYSHARD_GRAD, device="cpu")
    np.testing.assert_allclose(img, single.reshape(-1, 3), atol=1e-5, rtol=1e-5)


def test_dryrun_matches_the_reference_line(capsys):
    """dryrun_multichip in 4 ranks == MULTICHIP_r05.json's numbers (losses
    and the mean rtol 1e-4, gradient sums 1e-3): none of them depends on
    the world size but for the order of sums."""
    line = json.loads((ROOT / "MULTICHIP_r05.json").read_text())["tail"]
    want = [float(x) for x in re.findall(r"=([0-9.]+)", line)]
    got = dryrun_multichip(WORLD, device="cpu")
    assert capsys.readouterr().out.startswith(f"dryrun_multichip({WORLD}): ")
    keys = ("rayshard_loss", "rayshard_grad", "insitu_mean", "insitu_diff_loss",
            "insitu_diff_dv")
    assert len(want) == len(keys)
    for k, v in zip(keys, want):
        rtol = 1e-3 if k in ("rayshard_grad", "insitu_diff_dv") else 1e-4
        np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)


def test_run_world_results_in_rank_order_and_failures_raised():
    """Results come back in rank order from gloo ranks of one CPU thread
    each; a rank that raises is re-raised with its traceback."""
    from spray_tpu_torch.dist.rayshard import make_mesh

    assert run_world(W.rank_info, 3, device="cpu") == [
        (r, 3, "gloo", 1) for r in range(3)]
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed(.|\n)*on purpose"):
        run_world(W.rank_info, 2, 1, device="cpu")
    with pytest.raises(RuntimeError, match="not initialised"):
        make_mesh(device="cpu")
