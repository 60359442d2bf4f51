"""spray_tpu_torch host build (scenes, partition, cluster pages) ==
spray_tpu's on the same seeds."""

import numpy as np
import pytest

from spray_tpu import native as j_native
from spray_tpu.domains.partition import median_split_assign as j_assign
from spray_tpu.io import scenes as js
from spray_tpu.kernels.binned import BinnedScene as JBinnedScene
from spray_tpu.kernels.brute import PallasBruteIntersector as JPallasBrute
from spray_tpu.kernels.multidomain import build_cluster_domains as j_build
from spray_tpu_torch.domains.partition import median_split_assign as t_assign
from spray_tpu_torch.interop import binned_arrays, brute_arrays
from spray_tpu_torch.io import scenes as ts
from spray_tpu_torch.kernels.binned import BinnedScene as TBinnedScene
from spray_tpu_torch.kernels.brute import brute_table
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


def _check_pages(pj, pt, atol=2e-6):
    for k in ("meta", "tri_ids", "aabb", "bounds"):
        assert pj[k].shape == pt[k].shape, k
        np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)
    assert pt["w"].dtype == pj["w"].dtype and pt["w"].shape == pj["w"].shape
    if j_native.get_lib() is not None:
        # the reference built its transforms with its native library: the
        # port's native library and its float64 fallback give the same bits
        assert pt["w"].tobytes() == pj["w"].tobytes()
    else:
        # the reference fell back to its float32 np.linalg.inv
        np.testing.assert_allclose(pt["w"], pj["w"], rtol=0, atol=atol)


@pytest.mark.parametrize("cluster", [None, 64])
def test_cluster_domains_equal(cluster):
    pj = j_build(js.wisp_cloud(8, 80, extent=4.0), n_domains=6, cluster=cluster)
    pt = t_build(ts.wisp_cloud(8, 80, extent=4.0), n_domains=6, cluster=cluster)
    _check_pages(pj, pt)
    assert 1 <= tree_depth(pt["meta"]) <= 8


def test_cluster_domains_equal_on_the_41k_wisp_scene():
    """The 40,962-tri scene of chip_smoke.py phase 2, where the reference's
    float32 fallback is further off the float64 formula than 2e-6."""
    pj = j_build(js.wisp_cloud(8, 2048, seed=3), n_domains=6)
    pt = t_build(ts.wisp_cloud(8, 2048, seed=3), n_domains=6)
    _check_pages(pj, pt, atol=1e-4)


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


@pytest.mark.parametrize("name", sorted(SCENES))
def test_binned_scene_and_brute_table_equal(name):
    """The port's BinnedScene arrays == the reference's on the same scene:
    shapes and tri_ids exactly, floats to the 2e-6 allowed the pages; the
    brute triangle table exactly."""
    sj, st = SCENES[name](js), SCENES[name](ts)
    bj = binned_arrays(JBinnedScene(sj.vertices, sj.faces))
    bt = TBinnedScene(st.vertices, st.faces)
    assert bt.num_supernodes == bt.sbox.shape[0] == bj["sbox"].shape[0]
    for k, a in bt.arrays().items():
        assert a.shape == bj[k].shape and a.dtype == bj[k].dtype, k
    np.testing.assert_array_equal(bt.tri_ids, bj["tri_ids"])
    for k in ("tri9", "sbox", "world_lo", "world_hi"):
        np.testing.assert_allclose(bt.arrays()[k], bj[k], rtol=0, atol=2e-6,
                                   err_msg=k)
    # cluster boxes: padded clusters and the null supernode are (+inf, -inf)
    fin = np.isfinite(bj["cbox"])
    np.testing.assert_array_equal(np.isfinite(bt.cbox), fin)
    np.testing.assert_array_equal(bt.cbox[~fin], bj["cbox"][~fin])
    np.testing.assert_allclose(bt.cbox[fin], bj["cbox"][fin], rtol=0, atol=2e-6)
    assert np.isinf(bt.cbox[-1]).all() and (bt.tri9[-1] == 0).all()
    tri9, ids = brute_table(st)
    jtri9, jids = brute_arrays(JPallasBrute(sj, interpret=True))
    assert tri9.tobytes() == jtri9.tobytes()
    np.testing.assert_array_equal(ids, jids)


LAUNCHERS = ["spray_nearest", "spray_anyhit", "spray_nearest_slot",
             "spray_brute_nearest", "spray_brute_anyhit",
             "spray_binned_nearest", "spray_binned_anyhit",
             "spray_route_slots", "spray_threefry_uniform"]


@pytest.mark.parametrize("fn", LAUNCHERS)
def test_ctypes_signature_matches_the_c_launcher(fn):
    """The argtypes bound with ctypes follow the extern "C" launcher's
    parameter list in the CUDA source: a pointer (and the stream) is a
    c_void_p, never an int that would cut a 64-bit address; an int is a
    c_int, a uint32_t a c_uint32 (a seed of 0xFFFFFFFF is not cut to a
    signed int), a long long a c_longlong; the counts agree."""
    import ctypes
    import re

    from spray_tpu_torch.kernels import _build

    text = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    found = re.findall(r"\nint %s\(([^)]*)\)\s*{" % fn, text)
    assert len(found) == 1, fn
    params = [p.strip() for p in found[0].split(",")]
    scalars = {"int": ctypes.c_int, "uint32_t": ctypes.c_uint32,
               "long long": ctypes.c_longlong}
    want = [ctypes.c_void_p if "*" in p else scalars[p.rsplit(" ", 1)[0]]
            for p in params]
    assert _build._SIGNATURES[fn] == want
    assert params[-1] == "void* stream"
