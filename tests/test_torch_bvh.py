"""The port's BVH (spray_tpu_torch/bvh) against spray_tpu's: the builder's
arrays bit for bit, the stackful traversal (batched torch ops here, a
vmapped jnp while_loop there) on the same FlatBVH and rays, the brute
oracle, and a render through it against the numpy oracle, on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.bvh import builder as jbuilder
from spray_tpu.bvh.traverse import BVHIntersector as JBVH
from spray_tpu.bvh.traverse import DeviceBVH as JDeviceBVH
from spray_tpu.core import camera as j_camera
from spray_tpu.core.config import RenderConfig as JConfig
from spray_tpu.io import scenes as js
from spray_tpu.oracle import render_oracle
from spray_tpu_torch.bvh import builder as tbuilder
from spray_tpu_torch.bvh.traverse import STACK_DEPTH, BVHIntersector, DeviceBVH
from spray_tpu_torch.core.config import RenderConfig
from spray_tpu_torch.interop import camera_from_arrays, scene_from_arrays
from spray_tpu_torch.oracle.brute import BruteIntersector
from spray_tpu_torch.render import render

N = 512
SCENES = {
    "cornell": lambda: js.cornell_box(),
    "sphere": lambda: js.bumpy_sphere(subdiv=3),
    "wisp": lambda: js.wisp_cloud(n_blobs=12, tris_per_blob=80, extent=4.0,
                                  seed=5),
    # every triangle twice: each hit is an exact tie, which the walk decides
    "cornell_twice": lambda: js.merge_scenes([js.cornell_box(), js.cornell_box()]),
}
LEAF = {"cornell": 8, "sphere": 8, "wisp": 16, "cornell_twice": 4}


def _rays(scene, seed):
    """N rays around the scene; some dead (empty or NaN windows), some with
    finite windows or tmin > 0."""
    v = np.asarray(scene.vertices)
    rs = np.random.RandomState(seed)
    o = rs.uniform(v.min(0) - 1, v.max(0) + 1, (N, 3)).astype(np.float32)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(N, np.float32)
    tmin[3::11] = 0.5
    tmax = np.full(N, np.inf, np.float32)
    tmax[::13] = 0.0
    tmax[1::17] = 2.0
    tmax[2::29] = np.nan
    return o, d, tmin, tmax


@pytest.mark.parametrize("name", ["cornell", "wisp"])
def test_builder_matches_reference(name):
    """FlatBVH and the reordered triangle arrays bit for bit, and the
    reference's invariants (tests/test_bvh.py::test_builder_invariants)."""
    scene = SCENES[name]()
    jb = jbuilder.build_bvh(scene.vertices, scene.faces, leaf_size=LEAF[name])
    tb = tbuilder.build_bvh(scene.vertices, scene.faces, leaf_size=LEAF[name])
    for f in dataclasses.fields(jbuilder.FlatBVH):
        a, b = getattr(jb, f.name), getattr(tb, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name
    for a, b in zip(jbuilder.reordered_tri_arrays(scene.vertices, scene.faces, jb),
                    tbuilder.reordered_tri_arrays(scene.vertices, scene.faces, tb)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    order = tb.tri_order
    assert sorted(order[order >= 0].tolist()) == list(range(scene.num_faces))
    assert len(order) % tb.leaf_size == 0
    leaf = tb.child_node <= -2
    firsts = -(tb.child_node[leaf] + 2)
    assert (firsts >= 0).all() and (firsts < len(order)).all()
    assert (tb.child_count[leaf] > 0).all()
    assert (tb.child_node[tb.child_node >= 0] < tb.num_nodes).all()


@pytest.fixture(scope="module", params=list(SCENES))
def walked(request):
    """The reference's BVHIntersector and the port's on the same FlatBVH and
    rays: (scene, rays, reference hits and occlusion, port intersector)."""
    name = request.param
    scene = SCENES[name]()
    flat = jbuilder.build_bvh(scene.vertices, scene.faces, leaf_size=LEAF[name])
    tris = jbuilder.reordered_tri_arrays(scene.vertices, scene.faces, flat)
    rays = _rays(scene, 1)
    jx = JBVH(bvh=JDeviceBVH.from_flat(flat, *tris))
    hj = jx.intersect(*map(jnp.asarray, rays))
    hj = {k: np.asarray(getattr(hj, k)) for k in ("t", "prim", "u", "v", "valid")}
    far = np.full(N, 1e30, np.float32)
    occ_j = np.asarray(jx.occluded(jnp.asarray(rays[0]), jnp.asarray(rays[1]),
                                   jnp.asarray(far)))
    tx = BVHIntersector(bvh=DeviceBVH.from_flat(flat, *tris, device="cpu"))
    return name, scene, rays, hj, occ_j, tx


def test_traversal_matches_reference(walked):
    """valid and occlusion equal, t within rtol 2e-4, prims equal with no
    tie tolerance: the walk's order decides equal-t prims as the
    reference's does."""
    _, _, rays, hj, occ_j, tx = walked
    ht = tx.intersect(*map(torch.as_tensor, rays))
    valid = hj["valid"]
    np.testing.assert_array_equal(ht.valid.numpy(), valid)
    np.testing.assert_array_equal(ht.prim.numpy(), hj["prim"])
    np.testing.assert_allclose(ht.t.numpy()[valid], hj["t"][valid], rtol=2e-4)
    np.testing.assert_array_equal(ht.t.numpy()[~valid], rays[3][~valid])
    np.testing.assert_allclose(ht.u.numpy(), hj["u"], atol=1e-5)
    np.testing.assert_allclose(ht.v.numpy(), hj["v"], atol=1e-5)
    far = torch.full((N,), 1e30)
    occ = tx.occluded(torch.as_tensor(rays[0]), torch.as_tensor(rays[1]), far)
    np.testing.assert_array_equal(occ.numpy(), occ_j)
    assert 20 < valid.sum() < N and occ_j.any()


@pytest.mark.parametrize("name,seed", [("cornell", 1), ("sphere", 2)])
def test_traversal_matches_brute(name, seed):
    """Counterparts of tests/test_bvh.py's brute comparisons."""
    jscene = SCENES[name]()
    scene = scene_from_arrays(jscene.vertices, jscene.faces, jscene.albedo,
                              jscene.emission)
    o, d = (torch.as_tensor(x) for x in _rays(scene, seed)[:2])
    tmin, tmax = torch.zeros(N), torch.full((N,), float("inf"))
    brute = BruteIntersector(scene, device="cpu")
    bvh = BVHIntersector(scene, leaf_size=8, device="cpu")
    hb, hv = brute.intersect(o, d, tmin, tmax), bvh.intersect(o, d, tmin, tmax)
    np.testing.assert_array_equal(hb.valid.numpy(), hv.valid.numpy())
    m = hb.valid.numpy()
    np.testing.assert_allclose(hb.t.numpy()[m], hv.t.numpy()[m], rtol=1e-5,
                               atol=1e-6)
    assert (hb.prim.numpy()[m] == hv.prim.numpy()[m]).mean() > 0.999
    far = torch.full((N,), 1e30)
    np.testing.assert_array_equal(brute.occluded(o, d, far).numpy(),
                                  bvh.occluded(o, d, far).numpy())


def test_stack_overflow_drops_pushes_as_the_reference():
    """A tree that outgrows the stack: a chain of nodes, each with 6 empty
    internal children, a leaf (slot 6) and the next node of the chain (slot
    7), so each level leaves 6 entries on the stack.  Pushes beyond
    STACK_DEPTH are dropped and pops beyond it read its top (an empty node
    here), as JAX's scatter and gather do: the chain is cut after level 15,
    and the nearer triangles of the deeper levels are never found, by the
    port's walk as by the reference's."""
    b, depth = 8, 20
    dead = depth  # the empty node: every slot -1
    lo = np.full((depth + 1, b, 3), np.inf, np.float32)
    hi = np.full((depth + 1, b, 3), -np.inf, np.float32)
    node = np.full((depth + 1, b), -1, np.int32)
    count = np.zeros((depth + 1, b), np.int32)
    lo[:depth], hi[:depth] = -1.0, 1.0
    node[:depth, :6] = dead
    node[:depth, 6] = -(np.arange(depth) + 2)  # leaf k: triangle k
    count[:depth, 6] = 1
    node[:depth - 1, 7] = np.arange(1, depth)
    flat = jbuilder.FlatBVH(child_lo=lo, child_hi=hi, child_node=node,
                            child_count=count,
                            tri_order=np.arange(depth, dtype=np.int32),
                            leaf_size=1, world_lo=np.full(3, -1, np.float32),
                            world_hi=np.ones(3, np.float32))
    # triangle k lies at z = -1 + k / 10: the deeper, the nearer the rays
    v0 = np.stack([np.full(depth, -1.0), np.full(depth, -1.0),
                   -1.0 + np.arange(depth) / 10], axis=1).astype(np.float32)
    e1 = np.tile(np.float32([4, 0, 0]), (depth, 1))
    e2 = np.tile(np.float32([0, 4, 0]), (depth, 1))
    orig = np.arange(depth, dtype=np.int32)
    n = 64
    rs = np.random.RandomState(4)
    o = np.concatenate([rs.uniform(-0.5, 0.5, (n, 2)), np.full((n, 1), 2.0)],
                       axis=1).astype(np.float32)
    d = np.tile(np.float32([0, 0, -1]), (n, 1))
    tmin, tmax = np.zeros(n, np.float32), np.full(n, np.inf, np.float32)
    tmax[::3] = 1.55
    jx = JBVH(bvh=JDeviceBVH.from_flat(flat, v0, e1, e2, orig))
    hj = jx.intersect(*map(jnp.asarray, (o, d, tmin, tmax)))
    tx = BVHIntersector(bvh=DeviceBVH.from_flat(flat, v0, e1, e2, orig,
                                                device="cpu"))
    ht = tx.intersect(*map(torch.as_tensor, (o, d, tmin, tmax)))
    assert 6 * depth > STACK_DEPTH
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    np.testing.assert_array_equal(ht.valid.numpy(), np.asarray(hj.valid))
    assert (ht.prim.numpy() == 15).all()  # the deepest level reached


def test_pt_parity_bvh_intersector():
    """Counterpart of test_oracle_parity.py::test_pt_parity_bvh_intersector:
    the full renderer through the port's BVHIntersector == the numpy
    oracle."""
    jscene = js.cornell_box()
    jcam = j_camera.make_camera(eye=(0.5, 0.5, 2.2), lookat=(0.5, 0.5, 0.0),
                                up=(0, 1, 0), fov_y_deg=40, width=48, height=48)
    kw = dict(width=48, height=48, spp=1, bounces=2, integrator="pt", seed=3)
    ref = np.asarray(render_oracle(jscene, jcam, JConfig(**kw)))
    scene = scene_from_arrays(jscene.vertices, jscene.faces, jscene.albedo,
                              jscene.emission)
    cam = camera_from_arrays(jcam.eye, jcam.lower_left, jcam.du, jcam.dv,
                             jcam.width, jcam.height)
    img = render(scene, cam, RenderConfig(**kw), device="cpu",
                 intersector=BVHIntersector(scene, leaf_size=8, device="cpu"))
    np.testing.assert_allclose(img, ref, atol=2e-3, rtol=1e-3)
    assert ref.max() > 0.5
