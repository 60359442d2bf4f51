"""`binned.anyhit_visits_split_reference`, the host model of how the CUDA
`binned_anyhit_kernel` splits a run of visits over blocks and ORs their
flags per ray, and `binned.anyhit_serial_tests`, the count of tests the
serial order needs (the kernel's bound), on the CPU: the model against the
serial plain version `anyhit_visits_reference` and spray_tpu's Pallas
`_anyhit_kernel` (interpret mode), on the visit lists of real binned and
sweep calls and on hand-built lists (runless visits, packets occluded at
input, hits in a long run's first or last span); the count against an
independent per-run count and a hand count."""

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
GC = tbin.GROUP * tbin.CLUSTER
WHOLE = 1 << 20  # a span longer than any list: one block walks each run
SPANS = [1, 3, 7, WHOLE]


def cols_of(visits):
    return [torch.as_tensor(np.ascontiguousarray(visits[:, i])) for i in range(5)]


def split_equals_serial(visits, rays, tri9, occ, spans=SPANS):
    """The split model at every span == the serial plain version, exactly;
    returns the serial result."""
    args = (*cols_of(visits), *rays, tri9)
    ref = tbin.anyhit_visits_reference(*args, occ)
    for span in spans:
        got = tbin.anyhit_visits_split_reference(*args, occ, span)
        assert got.dtype == ref.dtype and torch.equal(got, ref), span
    return ref


def per_run_tests(pkt, sn, cmask, first, last, o, d, tmin, tmax, tri9, occ):
    """An independent count of the serial order's tests: per run, every
    gated column of its visits laid out in (visit, cluster, row) order, a
    lane's tests run to its first hit or to the end."""
    tests = torch.zeros(o.shape[0], dtype=torch.int64)
    lane = torch.arange(BP)
    starts = np.nonzero(first.numpy())[0]
    ends = np.nonzero(last.numpy())[0]
    for a in starts:
        b = ends[np.searchsorted(ends, a)]
        ray_idx = int(pkt[a]) * BP + lane
        tms = []
        for v in range(a, b + 1):
            for k in range(tbin.GROUP):
                if (int(cmask[v]) >> k) & 1:
                    tms.append(tbin._cluster_t(tri9, sn[v:v + 1], k, o, d,
                                               ray_idx[None])[0])
        if not tms:
            continue
        tm = torch.cat(tms)  # (columns, BP)
        hit = (tm > tmin[ray_idx]) & (tm < tmax[ray_idx])
        n = torch.where(hit.any(dim=0), hit.to(torch.uint8).argmax(dim=0) + 1,
                        tm.shape[0])
        live = (occ[ray_idx] == 0) & (tmax[ray_idx] > tmin[ray_idx])
        tests[ray_idx] = torch.where(live, n, 0)
    return tests


@pytest.fixture(scope="module")
def visit_case():
    """The hand-built list of tests/test_torch_binned.py (runs of 3, 1 and 2
    visits over 5 packets, a zero mask and the null supernode among them,
    packets 1 and 4 with no run), flags set at input on some lanes of
    packet 3 and on every lane of packet 2."""
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
    occ = np.zeros(n, np.int32)
    occ[3 * BP:3 * BP + 40] = 1
    occ[2 * BP:3 * BP] = 1
    return b, (o, d, tmin, tmax), visits, occ


@pytest.mark.parametrize("span", SPANS, ids=[f"span{s}" for s in SPANS])
def test_split_equals_serial_and_pallas_on_visit_case(visit_case, span):
    b, (o, d, tmin, tmax), visits, occ = visit_case
    tri9 = torch.as_tensor(binned_arrays(b)["tri9"])
    rays = [torch.as_tensor(x) for x in (o, d, tmin, tmax)]
    ref = split_equals_serial(visits, rays, tri9, torch.as_tensor(occ), [span])
    aug, _ = jbin._rays_to_aug(*map(jnp.asarray, (o, d, tmin, tmax)))
    p = aug.shape[0]
    jo = jbin._anyhit_visits(*(jnp.asarray(visits[:, i]) for i in range(5)),
                             aug, b.tri9, jnp.asarray(occ).reshape(p, 1, BP),
                             True)
    jo = np.asarray(jo).reshape(-1)
    visited = np.isin(np.arange(p), visits[:, 0]).repeat(BP)
    got = ref.numpy()
    np.testing.assert_array_equal(got[visited], jo[visited])
    # packets with no run keep their inputs (Pallas leaves them unwritten)
    np.testing.assert_array_equal(got[~visited], occ[~visited])
    newly = visited & (occ == 0)
    assert got[newly].any() and not got[newly].all()
    assert got[2 * BP:3 * BP].all()  # occluded at input stays occluded


@pytest.mark.parametrize("kind", ["binned", "sweep"])
def test_split_equals_serial_on_intersector_lists(kind, monkeypatch):
    """The visit lists one occluded call of each tracer launches (the
    sweep's chunks hold runs of many visits), at every span; the serial
    count equals the per-run count on them."""
    scene = js.wisp_cloud(n_blobs=6, tris_per_blob=800, seed=2)
    port = scene_from_arrays(scene.vertices, scene.faces, scene.albedo,
                             scene.emission)
    cls = tbin.BinnedIntersector if kind == "binned" else tsweep.SweepIntersector
    isect = cls(port, device="cpu")
    calls = []

    def record(*args):
        calls.append(args)
        return tbin.anyhit_visits_reference(*args)

    monkeypatch.setattr(tbin, "anyhit_visits", record)
    monkeypatch.setattr(tsweep, "anyhit_visits", record)
    rng = np.random.default_rng(3)
    v = np.asarray(scene.vertices)
    ctr, ext = v.mean(0), float(np.ptp(v, axis=0).max())
    n = 300
    o = np.tile(ctr + np.array([0.0, 0.0, 2.0 * ext]), (n, 1)).astype(np.float32)
    d = ctr + (rng.random((n, 3)) - 0.5) * ext - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.full(n, 2.0 * ext, np.float32)
    tmax[::7] = 0.0  # dead lanes: an empty window
    occ = isect.occluded(torch.as_tensor(o), torch.as_tensor(d),
                         torch.as_tensor(tmax))
    assert calls and occ.any() and not occ.all()
    longest = 0
    for args in calls[:4]:
        first, last = args[3].numpy(), args[4].numpy()
        starts, ends = np.nonzero(first)[0], np.nonzero(last)[0]
        longest = max(longest, int((ends - starts).max()) + 1)
        ref = tbin.anyhit_visits_reference(*args)
        for span in (1, 3, 7):
            assert torch.equal(
                ref, tbin.anyhit_visits_split_reference(*args, span))
        assert torch.equal(tbin.anyhit_serial_tests(*args),
                           per_run_tests(*args))
    assert longest > 7  # some runs cross span boundaries


def _one_triangle_tri9():
    """Two supernodes (and the null one): supernode 0 holds the triangle
    (0,0,0) (1,0,0) (0,1,0) at row 5 of cluster 0, supernode 1 the same
    triangle one unit further along -z; every other row is degenerate."""
    tri9 = np.zeros((3, 9, GC), np.float32)
    for s, z in ((0, 0.0), (1, -1.0)):
        tri9[s, 2, 5] = z
        tri9[s, 3, 5] = 1.0  # e1 = (1, 0, 0)
        tri9[s, 7, 5] = 1.0  # e2 = (0, 1, 0)
    return torch.as_tensor(tri9)


def _down_rays(n):
    """n rays from (0.25, 0.25, 2) along -z: t = 2 on supernode 0, 3 on 1."""
    o = np.tile(np.float32([0.25, 0.25, 2.0]), (n, 1))
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (n, 1))
    return o, d


def test_long_runs_runless_visits_and_occluded_packets():
    """Packet 0's only hit lies in the last span of a run of 23 visits;
    packet 1's in the first span of one (its later spans find nothing and
    must keep the 1); packet 2 is occluded at input and walks a run that
    would not occlude it; packet 3's visits lie between a run's `last` and
    the next `first`; packet 4 has no run."""
    tri9 = _one_triangle_tri9()
    n = 5 * BP
    o, d = _down_rays(n)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[7::BP] = 1.5  # ends before either triangle: never occluded
    null = [2, 0xFF, 0, 0]
    run0 = [[0, *null]] * 22 + [[0, 0, 0x01, 0, 1]]
    run1 = [[1, 0, 0x01, 1, 0]] + [[1, *null]] * 21 + [[1, 2, 0xFF, 0, 1]]
    visits = np.array(
        [[0, 2, 0xFF, 1, 0]] + run0[1:] + run1
        + [[2, 2, 0xFF, 1, 0], [2, 2, 0x0F, 0, 1]]
        + [[3, 0, 0x01, 0, 0], [3, 1, 0x01, 0, 0]],
        np.int32)
    occ = np.zeros(n, np.int32)
    occ[2 * BP:3 * BP] = 1
    rays = [torch.as_tensor(x) for x in (o, d, tmin, tmax)]
    got = split_equals_serial(visits, rays, tri9, torch.as_tensor(occ),
                              SPANS + [2, 4, 8]).view(5, BP)
    want = torch.ones(5, BP, dtype=torch.int32)
    want[:2, 7] = 0
    want[3:] = 0
    assert torch.equal(got, want)
    # the serial count: packet 0 tests 22 null supernodes of 8 clusters,
    # then row 5; packet 1 stops at row 5 of its first visit; the lane whose
    # window ends first tests every gated row of its run
    tests = tbin.anyhit_serial_tests(*cols_of(visits), *rays, tri9,
                                     torch.as_tensor(occ)).view(5, BP)
    assert (tests[0] == torch.where(torch.arange(BP) == 7, 22 * GC + BP,
                                    22 * GC + 6)).all()
    assert (tests[1] == torch.where(torch.arange(BP) == 7, BP + 22 * GC,
                                    6)).all()
    assert not tests[2:].any()


def test_serial_tests_hand_count():
    """Lane by lane on one run (supernode 1 with clusters 0 and 2 gated,
    then supernode 0 with cluster 0), next to runless visits and a run with
    no gated cluster:
      - lane 0 hits row 5 of supernode 1 at t = 3: 6 tests;
      - lane 1's window ends at 2.5: all 256 rows of supernode 1, then 6;
      - lane 2 is occluded at input and lane 3's window is empty: none;
      - lane 4's window starts at 2.5: t = 3 is in it: 6;
      - lane 5 looks along +z and hits nothing: 384;
      - every other lane as lane 0."""
    tri9 = _one_triangle_tri9()
    n = 3 * BP
    o, d = _down_rays(n)
    d[5] = (0.0, 0.0, 1.0)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[1] = 2.5
    tmax[3] = 0.0
    tmin[4] = 2.5
    occ = np.zeros(n, np.int32)
    occ[2] = 1
    visits = np.array([
        [0, 1, 0b101, 1, 0],
        [0, 0, 0x01, 0, 1],
        [1, 0, 0x01, 0, 0],  # between a `last` and the next `first`
        [2, 2, 0x00, 1, 1],  # a run with no gated cluster
    ], np.int32)
    args = (*cols_of(visits), *(torch.as_tensor(x) for x in (o, d, tmin, tmax)),
            tri9, torch.as_tensor(occ))
    tests = tbin.anyhit_serial_tests(*args)
    want = torch.zeros(n, dtype=torch.int64)
    want[:BP] = 6
    want[1], want[2], want[3], want[5] = 2 * BP + 6, 0, 0, 3 * BP
    assert torch.equal(tests, want)
    assert torch.equal(tests, per_run_tests(*args))
    assert int(tests.sum()) == 6 * 124 + 262 + 384
    occ_out = split_equals_serial(visits, args[5:9], tri9, args[10])
    assert occ_out[:BP].tolist() == [1, 1, 1, 0, 1, 0] + [1] * (BP - 6)
    assert not occ_out[BP:].any()
