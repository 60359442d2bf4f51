"""spray_tpu_torch host build (scenes, partition, cluster pages) ==
spray_tpu's on the same seeds."""

import numpy as np
import pytest

from spray_tpu.domains.partition import median_split_assign as j_assign
from spray_tpu.io import scenes as js
from spray_tpu.kernels.multidomain import build_cluster_domains as j_build
from spray_tpu_torch.domains.partition import median_split_assign as t_assign
from spray_tpu_torch.io import scenes as ts
from spray_tpu_torch.kernels.multidomain import build_cluster_domains as t_build
from spray_tpu_torch.kernels.traverse import tree_depth

SCENES = {
    "cornell": lambda m: m.cornell_box(),
    "sphere": lambda m: m.bumpy_sphere(3),
    "wisps": lambda m: m.wisp_cloud(8, 80, extent=4.0),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scenes_byte_equal(name):
    sj, st = SCENES[name](js), SCENES[name](ts)
    for f in ("vertices", "faces", "albedo", "emission"):
        a, b = getattr(sj, f), getattr(st, f)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("n_domains", [2, 6, 7])
def test_median_split_assign_equal(n_domains):
    c = np.random.RandomState(n_domains).uniform(size=(999, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_assign(c, n_domains), j_assign(c, n_domains))


def _check_pages(pj, pt):
    for k in ("meta", "tri_ids", "aabb", "bounds"):
        assert pj[k].shape == pt[k].shape, k
        np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)
    # the reference may build transforms with its native library, which
    # rounds differently from numpy by ~1e-6
    np.testing.assert_allclose(pt["w"], pj["w"], rtol=0, atol=2e-6)


@pytest.mark.parametrize("cluster", [None, 64])
def test_cluster_domains_equal(cluster):
    pj = j_build(js.wisp_cloud(8, 80, extent=4.0), n_domains=6, cluster=cluster)
    pt = t_build(ts.wisp_cloud(8, 80, extent=4.0), n_domains=6, cluster=cluster)
    _check_pages(pj, pt)
    assert 1 <= tree_depth(pt["meta"]) <= 8


def test_placeholder_pages_for_empty_domains():
    pj = j_build(js.icosphere(subdiv=1), n_domains=128)
    pt = t_build(ts.icosphere(subdiv=1), n_domains=128)
    _check_pages(pj, pt)
    empty = (pt["tri_ids"] >= 0).sum(axis=1) == 0
    assert empty.any()
    # far point box at 2e30, no valid child, never-hit transforms
    np.testing.assert_array_equal(pt["aabb"][empty], np.float32(2e30))
    assert (pt["meta"][empty] == -1).all()
    assert (pt["w"][empty] == 0).all()
