"""spray_tpu_torch.native and the cluster builders == spray_tpu's.

The port's native library and its numpy fallbacks give the same Morton
order and the same Woop transforms bit for bit; so do the reference's
native library, wherever it loaded in this process.  The cluster BVH of
kernels/cluster_bvh.py gives the reference's arrays."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from spray_tpu import native as jnative
from spray_tpu.io import scenes as js
from spray_tpu.kernels import cluster_bvh as jcb
from spray_tpu_torch import native
from spray_tpu_torch.io import scenes as ts
from spray_tpu_torch.kernels import cluster_bvh as cb

ROOT = Path(__file__).resolve().parents[1]
SCENES = {
    "cornell": lambda m: m.cornell_box(),
    "sphere": lambda m: m.bumpy_sphere(3),
    "wisps": lambda m: m.wisp_cloud(8, 80, extent=4.0),
    "wisp41k": lambda m: m.wisp_cloud(8, 2048, seed=3),
}
# max |w| difference of the reference's float32 np.linalg.inv fallback from
# the float64 formula, per scene
REF_F32_INV_ATOL = {"cornell": 2e-6, "sphere": 1e-5, "wisps": 2e-6,
                    "wisp41k": 1e-4}


def _tri_inputs(scene):
    tv = np.asarray(scene.vertices)[np.asarray(scene.faces).reshape(-1)]
    tv = tv.reshape(-1, 3, 3)
    v0 = tv[:, 0].astype(np.float32)
    e1 = (tv[:, 1] - tv[:, 0]).astype(np.float32)
    e2 = (tv[:, 2] - tv[:, 0]).astype(np.float32)
    return tv, v0, e1, e2


def test_library_builds_outside_the_source_tree():
    lib = native.get_lib()
    assert lib is not None, "g++ expected on this machine"
    assert Path(lib._name).parent == native.BUILD_DIR
    assert not list(native.SRC.parent.glob("*.so"))


@pytest.mark.parametrize("name", ["sphere", "wisp41k"])
def test_morton_order_native_fallback_numpy_equal(name):
    tv, *_ = _tri_inputs(SCENES[name](ts))
    tlo, thi = tv.min(1), tv.max(1)
    order = native.morton_order(tlo, thi)
    np.testing.assert_array_equal(order, cb._morton_order(tlo, thi))
    np.testing.assert_array_equal(order, jcb._morton_order(tlo, thi))


@pytest.mark.parametrize("name", ["sphere", "wisp41k"])
def test_transforms_native_and_fallback_bit_equal(name):
    """Degenerate rows (a zero edge, collinear edges) included: they get
    the never-hit transform in both."""
    _, v0, e1, e2 = _tri_inputs(SCENES[name](ts))
    e1[:3] = 0.0
    e2[3:6] = 2.0 * e1[3:6]
    got = native.tri_transforms(v0, e1, e2)
    fallback = cb.tri_transforms(v0, e1, e2)
    assert got.dtype == fallback.dtype == np.float32
    assert got.tobytes() == fallback.tobytes()
    np.testing.assert_array_equal(got[:6, :3], 0.0)
    np.testing.assert_array_equal(got[:6, 3], [[0, 0, 1]] * 6)
    if jnative.get_lib() is not None:
        assert jnative.tri_transforms(v0, e1, e2).tobytes() == got.tobytes()
    # the reference's float32 fallback only within its rounding
    np.testing.assert_allclose(got, jcb.tri_transforms(v0, e1, e2), rtol=0,
                               atol=REF_F32_INV_ATOL[name])


def test_four_processes_build_one_fresh_directory(tmp_path):
    """Four processes build into one empty directory at once: each loads a
    whole library, one file stays, no temporary is left behind."""
    code = ("import sys; from pathlib import Path\n"
            "from spray_tpu_torch import native\n"
            "lib = native.load(Path(sys.argv[1]))\n"
            "import numpy as np\n"
            "t = np.random.RandomState(0).uniform(size=(999, 3)).astype(np.float32)\n"
            "out = np.empty(999, np.int64)\n"
            "lib.spray_morton_order(t, t + 1, 999, out)\n"
            "print(sorted(out) == list(range(999)))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "True"
    assert [f.suffix for f in tmp_path.iterdir()] == [".so"]


def _ref_w_native(tv, tri_ids):
    """The reference's page transforms as its native library builds them,
    for the triangle order `tri_ids` (Nc, C)."""
    nc, c = tri_ids.shape
    perm = tri_ids.reshape(-1).astype(np.int64)
    valid = perm >= 0
    t = tv[np.where(valid, perm, 0)]
    v0 = np.where(valid[:, None], t[:, 0], 0.0).astype(np.float32)
    e1 = np.where(valid[:, None], t[:, 1] - t[:, 0], 0.0).astype(np.float32)
    e2 = np.where(valid[:, None], t[:, 2] - t[:, 0], 0.0).astype(np.float32)
    tf = jnative.tri_transforms(v0, e1, e2).reshape(nc, c, 4, 3)
    return np.transpose(tf, (0, 2, 3, 1)).reshape(nc, 4, 3 * c)


@pytest.mark.parametrize("name", ["cornell", "sphere", "wisp41k"])
def test_cluster_bvh_equals_reference(name):
    """Morton clusters under the 8-wide SAH tree: every array equal to the
    reference's; w bit for bit wherever the reference's native library
    loaded, else within its float32 fallback's rounding."""
    st, sj = SCENES[name](ts), SCENES[name](js)
    pt = cb.build_cluster_bvh(st.vertices, st.faces)
    pj = jcb.build_cluster_bvh(sj.vertices, sj.faces)
    for k in ("bounds", "meta", "tri_ids", "world_lo", "world_hi", "w"):
        a, b = getattr(pt, k), getattr(pj, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
    for k in ("bounds", "meta", "tri_ids", "world_lo", "world_hi"):
        assert getattr(pt, k).tobytes() == getattr(pj, k).tobytes(), k
    if jnative.get_lib() is not None:
        assert pt.w.tobytes() == pj.w.tobytes()
        assert pt.w.tobytes() == _ref_w_native(_tri_inputs(st)[0],
                                               pj.tri_ids).tobytes()
    np.testing.assert_allclose(pt.w, pj.w, rtol=0, atol=REF_F32_INV_ATOL[name])


@pytest.mark.parametrize("name,cluster", [("wisps", 64), ("wisp41k", cb.CLUSTER)])
def test_cluster_bvh_equals_reference_at_num_bins_8(name, cluster):
    """The reference's Morton path builds its cluster tree at 16 bins
    whatever `num_bins` says (it reaches only the triangle-SAH builder), so
    its pages at num_bins=8 equal the port's, which has no `num_bins`.  On
    these scenes a tree at 8 bins would be another tree."""
    st, sj = SCENES[name](ts), SCENES[name](js)
    pt = cb.build_cluster_bvh(st.vertices, st.faces, cluster=cluster)
    pj = jcb.build_cluster_bvh(sj.vertices, sj.faces, num_bins=8,
                               cluster=cluster)
    for k in ("bounds", "meta", "tri_ids", "world_lo", "world_hi"):
        assert getattr(pt, k).tobytes() == getattr(pj, k).tobytes(), k
    np.testing.assert_allclose(pt.w, pj.w, rtol=0, atol=REF_F32_INV_ATOL[name])
    _, _, clo, chi = cb.build_clusters(st.vertices, st.faces, cluster)
    _, meta8 = cb._build_sah_tree(clo, chi, 8, 8)
    assert meta8.tobytes() != pt.meta.tobytes()
