"""`binned.nearest_visits_split_reference`, the host model of how the CUDA
`binned_nearest_kernel` splits a run of visits over blocks and merges their
bests per ray, on the CPU: against the serial plain version
`nearest_visits_reference`, against spray_tpu's Pallas `_nearest_kernel`
(interpret mode), on the visit lists of real binned and sweep calls, and on
hand-built lists for each place where the tie rule could break (a
supernode visited twice in one run, a -0.0 hit, a hit at the incoming
best t, visits outside any run, a packet with no run)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.io import scenes as js
from spray_tpu.kernels import binned as jbin
from spray_tpu_torch.interop import binned_arrays, scene_from_arrays
from spray_tpu_torch.kernels import binned as tbin
from spray_tpu_torch.kernels import sweep as tsweep

BP = tbin.BP
WHOLE = 1 << 20  # a span longer than any list: one block walks each run
SPANS = [1, 3, 7, WHOLE]


def cols_of(visits):
    return [torch.as_tensor(np.ascontiguousarray(visits[:, i])) for i in range(5)]


def assert_bit_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.numpy().view(np.int32),
                                      y.numpy().view(np.int32))


def split_equals_serial(visits, rays, tri9, best_t, best_code, spans=SPANS):
    """The split model at every span == the serial plain version, bit for
    bit; returns the serial result."""
    args = (*cols_of(visits), *rays, tri9)
    ref = tbin.nearest_visits_reference(*args, best_t, best_code)
    for span in spans:
        got = tbin.nearest_visits_split_reference(*args, best_t, best_code,
                                                  span)
        assert_bit_equal(ref, got)
    return ref


@pytest.fixture(scope="module")
def visit_case():
    """The hand-built list of tests/test_torch_binned.py: runs of 3, 1 and 2
    visits over 5 packets (a zero mask and the null supernode among them),
    packets 1 and 4 with no run, windows that start inside the scene."""
    scene = js.wisp_cloud(n_blobs=6, tris_per_blob=800, seed=2)
    b = jbin.BinnedScene(scene.vertices, scene.faces)
    s = b.num_supernodes
    n = 5 * BP
    rng = np.random.default_rng(7)
    v = np.asarray(scene.vertices)
    lo, hi = v.min(0), v.max(0)
    ctr, ext = (lo + hi) / 2, float((hi - lo).max())
    o = np.tile(ctr + np.array([0.0, 0.0, 2.0 * ext]), (n, 1)).astype(np.float32)
    d = ctr + (rng.random((n, 3)) - 0.5) * ext - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmin = np.zeros(n, np.float32)
    tmin[5::9] = 2.0 * ext
    tmax = np.full(n, np.inf, np.float32)
    tmax[::11] = 0.0
    tmax[3::13] = 2.1 * ext
    visits = np.array([
        [0, 0, 0xFF, 1, 0],
        [0, 1, 0x00, 0, 0],
        [0, s, 0xFF, 0, 1],
        [2, 2, 0xA5, 1, 1],
        [3, 1, 0x0F, 1, 0],
        [3, 0, 0xF1, 0, 1],
    ], np.int32)
    return b, (o, d, tmin, tmax), visits


@pytest.mark.parametrize("span", SPANS, ids=[f"span{s}" for s in SPANS])
def test_split_equals_serial_and_pallas_on_visit_case(visit_case, span):
    b, (o, d, tmin, tmax), visits = visit_case
    tri9 = torch.as_tensor(binned_arrays(b)["tri9"])
    rays = [torch.as_tensor(x) for x in (o, d, tmin)]
    code0 = torch.full((o.shape[0],), -1, dtype=torch.int32)
    ref = split_equals_serial(visits, rays, tri9, torch.as_tensor(tmax), code0,
                              [span])
    aug, _ = jbin._rays_to_aug(*map(jnp.asarray, (o, d, tmin, tmax)))
    p = aug.shape[0]
    jt, jc = jbin._nearest_visits(
        *(jnp.asarray(visits[:, i]) for i in range(5)), aug, b.tri9,
        jnp.asarray(tmax).reshape(p, 1, BP),
        jnp.asarray(code0.numpy()).reshape(p, 1, BP), True)
    visited = np.isin(np.arange(p), visits[:, 0]).repeat(BP)
    jt, jc = np.asarray(jt).reshape(-1), np.asarray(jc).reshape(-1)
    got = tbin.nearest_visits_split_reference(*cols_of(visits), *rays, tri9,
                                              torch.as_tensor(tmax), code0, span)
    np.testing.assert_array_equal(got[1].numpy()[visited], jc[visited])
    assert (jc[visited] >= 0).any()
    # the same formula in the same order; XLA's fusion may move one ulp
    np.testing.assert_allclose(got[0].numpy()[visited], jt[visited], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got[0].numpy()[~visited], tmax[~visited])
    assert torch.equal(got[1], ref[1])


@pytest.mark.parametrize("kind", ["binned", "sweep"])
def test_split_equals_serial_on_intersector_lists(kind, monkeypatch):
    """The visit lists one intersect call of each tracer launches (the
    sweep's chunks hold runs of many visits), at every span."""
    scene = js.wisp_cloud(n_blobs=6, tris_per_blob=800, seed=2)
    port = scene_from_arrays(scene.vertices, scene.faces, scene.albedo,
                             scene.emission)
    cls = tbin.BinnedIntersector if kind == "binned" else tsweep.SweepIntersector
    isect = cls(port, device="cpu")
    calls = []

    def record(*args):
        calls.append(args)
        return tbin.nearest_visits_reference(*args)

    monkeypatch.setattr(tbin, "nearest_visits", record)
    monkeypatch.setattr(tsweep, "nearest_visits", record)
    rng = np.random.default_rng(3)
    v = np.asarray(scene.vertices)
    ctr, ext = v.mean(0), float(np.ptp(v, axis=0).max())
    n = 300
    o = np.tile(ctr + np.array([0.0, 0.0, 2.0 * ext]), (n, 1)).astype(np.float32)
    d = ctr + (rng.random((n, 3)) - 0.5) * ext - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    isect.intersect(torch.as_tensor(o), torch.as_tensor(d), torch.zeros(n),
                    torch.full((n,), float("inf")))
    assert calls
    longest = 0
    for args in calls[:4]:
        first, last = args[3].numpy(), args[4].numpy()
        starts, ends = np.nonzero(first)[0], np.nonzero(last)[0]
        longest = max(longest, int((ends - starts).max()) + 1)
        ref = tbin.nearest_visits_reference(*args)
        for span in (1, 3, 7):
            assert_bit_equal(ref, tbin.nearest_visits_split_reference(*args, span))
    assert longest > 7  # some runs cross span boundaries


def _supernodes_with_dup(b, s0):
    """tri9 with supernode s0 copied after the last real one (the null
    supernode stays last); returns (tri9, index of the copy)."""
    tri9 = binned_arrays(b)["tri9"]
    s = tri9.shape[0] - 1
    out = np.concatenate([tri9[:s], tri9[s0:s0 + 1], tri9[s:]])
    return torch.as_tensor(out), s


def test_duplicated_supernode_keeps_the_earlier_visit(visit_case):
    """A supernode and its copy in one run of more than 4 x span visits,
    in different spans: every ray that hits them hits both at the same t,
    and the earlier visit's supernode must win, whichever of the two comes
    first."""
    b, (o, d, tmin, _), _ = visit_case
    tri9, dup = _supernodes_with_dup(b, 0)
    rays = [torch.as_tensor(x) for x in (o, d, tmin)]
    n = o.shape[0]
    inf = torch.full((n,), float("inf"))
    code0 = torch.full((n,), -1, dtype=torch.int32)
    for a, z in ((0, dup), (dup, 0)):
        middle = [[0, 1 + (j % 2), 0x0F, 0, 0] for j in range(30)]
        visits = np.array([[0, a, 0xFF, 1, 0]] + middle + [[0, z, 0xFF, 0, 1]],
                          np.int32)
        t, code = split_equals_serial(visits, rays, tri9, inf, code0)
        lanes = code[:BP] >= 0
        sn_of = code[:BP][lanes] // (tbin.GROUP * tbin.CLUSTER)
        # the rays that took supernode 0's triangles took the earlier copy
        both = [int((sn_of == x).sum()) for x in (a, z)]
        assert both[0] > 0 and both[1] == 0, both


def _one_triangle_tri9():
    """Two supernodes (and the null one): supernode 0 holds the triangle
    (0,0,0) (1,0,0) (0,1,0) at row 5 of cluster 0, supernode 1 the same
    triangle one unit further along -z; every other row is degenerate."""
    tri9 = np.zeros((3, 9, tbin.GROUP * tbin.CLUSTER), np.float32)
    for s, z in ((0, 0.0), (1, -1.0)):
        tri9[s, 2, 5] = z
        tri9[s, 3, 5] = 1.0  # e1 = (1, 0, 0)
        tri9[s, 7, 5] = 1.0  # e2 = (0, 1, 0)
    return torch.as_tensor(tri9)


def test_negative_zero_window_and_runless_visits():
    """Lane 0 starts on the triangle looking along +z: its t is -0.0, which
    must come out as -0.0 (the merged key cannot carry the sign); lane 1
    looks along -z: +0.0.  Lanes 2 and 3 get the hit distance itself as
    their incoming best t: the strict window takes no hit, t and code stay.
    Packet 1's visits lie between a run's `last` and the next `first`, and
    packet 2 has no run: all their lanes keep their inputs."""
    tri9 = _one_triangle_tri9()
    n = 3 * BP
    o = np.tile(np.float32([0.25, 0.25, 0.0]), (n, 1))
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (n, 1))
    d[0] = (0.0, 0.0, 1.0)
    o[2:4, 2] = 2.0  # hits at t = 2 (supernode 0) and 3 (supernode 1)
    o[4:BP, 2] = 0.5
    tmin = np.zeros(n, np.float32)
    best_t = np.full(n, np.inf, np.float32)
    best_t[2], best_t[3] = 2.0, 3.0
    best_code = np.full(n, -1, np.int32)
    best_code[2:4] = 77
    best_code[BP:] = 99
    best_t[BP:] = 5.0
    visits = np.array([
        [0, 1, 0x01, 1, 0],
        [0, 2, 0x00, 0, 0],  # the null supernode, no cluster gated
        [0, 0, 0x01, 0, 1],
        [1, 0, 0x01, 0, 0],  # no run is open: never walked
        [1, 1, 0x01, 0, 0],
        [0, 1, 0x01, 0, 0],
    ], np.int32)
    rays = [torch.as_tensor(x) for x in (o, d, tmin)]
    t, code = split_equals_serial(visits, rays, tri9, torch.as_tensor(best_t),
                                  torch.as_tensor(best_code))
    bits = t.numpy().view(np.uint32)
    assert bits[0] == 0x80000000 and bits[1] == 0  # -0.0 and +0.0
    assert code[0] == code[1] == 5  # supernode 0, cluster 0, row 5
    # lane 2: t = 2 is not below its window 2; t = 3 from supernode 1 is not
    # either; lane 3: t = 2 beats its window 3
    assert t[2] == 2.0 and code[2] == 77
    assert t[3] == 2.0 and code[3] == 5
    assert (t[4:BP] == 0.5).all() and (code[4:BP] == 5).all()
    np.testing.assert_array_equal(t[BP:].numpy(), best_t[BP:])
    np.testing.assert_array_equal(code[BP:].numpy(), best_code[BP:])
