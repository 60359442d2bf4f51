"""tests_gpu/insitu_gate.py, the port's counterpart of
tests_tpu/insitu_gate.py, run small on the CPU: its check (`gate`) in a
world of one gloo rank on wisp_cloud(2, 256, seed=3) at 32x32, spp 1,
bounces 2, 8 domains, bucket 16,384.  The in-situ image is within the
gate's 1e-4 of the fast path's, the line has the reference gate's keys,
and its epochs and rays exchanged equal the reference's
make_insitu_renderer(...).last_stats on the same scene at a one-device
mesh.  The ratio is a wall-clock number on a CPU: printed, not asserted.
The gate's router check runs too, on the plain version."""

import numpy as np
import pytest

from spray_tpu.core.camera import make_camera as j_camera
from spray_tpu.core.config import RenderConfig as JConfig
from spray_tpu.dist.epochs import make_insitu_renderer as j_insitu
from spray_tpu.dist.rayshard import make_mesh as j_mesh
from spray_tpu.io.scenes import wisp_cloud as j_wisp
from spray_tpu_torch.core.camera import make_camera
from spray_tpu_torch.core.config import RenderConfig
from spray_tpu_torch.io.scenes import wisp_cloud
from tests_gpu import insitu_gate as G

SCENE = dict(n_blobs=2, tris_per_blob=256, seed=3)
CAM = dict(eye=(14.0, 10.0, 18.0), lookat=(0, 0, 0), up=(0, 1, 0),
           fov_y_deg=45, width=32, height=32)
CFG = dict(spp=1, bounces=2, integrator="pt", seed=0)
KEYS = {"ok", "insitu_s", "direct_s", "ratio", "max_img_diff", "epochs",
        "exchanged"}  # the reference gate's line


@pytest.fixture(scope="module")
def port():
    return G.gate(wisp_cloud(**SCENE), make_camera(**CAM), RenderConfig(**CFG),
                  device="cpu")


def test_gate_image_within_bound_and_reference_keys(port):
    print(f"in-situ {port['insitu_s']:.4f} s, fast path {port['direct_s']:.4f} "
          f"s, ratio {port['ratio']:.3f} (CPU wall clock)")
    assert set(port) == KEYS
    assert port["max_img_diff"] <= G.MAX_DIFF
    assert port["insitu_s"] > 0 and port["direct_s"] > 0
    assert port["ratio"] == port["insitu_s"] / port["direct_s"]
    assert port["ok"] == (port["ratio"] <= G.MAX_RATIO)


def test_gate_counters_match_reference(port):
    render = j_insitu(j_wisp(**SCENE), j_camera(**CAM), JConfig(**CFG), j_mesh(1),
                      n_domains=G.N_DOMAINS, bucket=G.BUCKET, backend="cluster")
    img = np.asarray(render())
    assert np.isfinite(img).all() and img.mean() > 0
    assert port["epochs"] == render.last_stats["epochs"] > 0
    assert port["exchanged"] == render.last_stats["rays_exchanged"] > 0


def test_route_check_on_the_cpu():
    """The gate's router check in a world of one gloo rank: every case of
    the plain version equals itself (the kernel is the card's), no launch
    is counted, and no device time is reported from the CPU."""
    res = G.route_check(wisp_cloud(**SCENE), make_camera(**CAM),
                        RenderConfig(**CFG), device="cpu")
    assert res["ok"] and set(res["cases"]) == set(G.ROUTE_CASES)
    assert all(res["cases"].values())
    assert res["frame_launches"] == 0 and res["frame_rounds"] > 0
    for k in ("kernel_ms", "call_ms", "bound_ms", "plain_ms", "library_ms"):
        assert res[k] is None
