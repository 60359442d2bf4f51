"""The in-situ router's send layout (`kernels.route.route_slots`, the plain
version on the CPU) against the one-hot cumsum formulation the epoch loop
used before it, written out here as the oracle, and against the layout's
invariants; and the epoch loop builds every round's layout through it.

The cases cross the world sizes of the tests and of the cell (1, 2, 4) and
8, buckets from 1 to every ray, owners drawn uniformly, all to one owner
(the overflow is held over), about half with no destination, and none,
and ray counts ragged against the CUDA kernel's 1,024-lane chunks up to
the cell's 262,144."""

import itertools

import numpy as np
import pytest
import torch

from spray_tpu_torch.dist import epochs as tep
from spray_tpu_torch.dist.rayshard import Mesh
from spray_tpu_torch.io.scenes import wisp_cloud
from spray_tpu_torch.kernels import route

NDEVS = (1, 2, 4, 8)
BUCKETS = (1, 7, 4096, "m")  # "m": a bucket that holds every ray
KINDS = ("uniform", "one_owner", "half_none")
MS = (1, 1023, 1025, 262144)
CASES = ([(n, b, k, m) for n, b, k, m in itertools.product(NDEVS, BUCKETS,
                                                           KINDS, MS)]
         + [(n, b, "empty", 0) for n, b in itertools.product(NDEVS,
                                                              BUCKETS[:3])])


def _dest(kind, m, ndev, seed):
    rs = np.random.RandomState(seed)
    if kind == "uniform":
        return rs.randint(0, ndev, m).astype(np.int64)
    if kind == "one_owner":
        return np.full(m, rs.randint(0, ndev), np.int64)
    if kind == "half_none":
        return np.where(rs.uniform(size=m) < 0.5, ndev,
                        rs.randint(0, ndev, m)).astype(np.int64)
    return np.zeros(0, np.int64)


def _oracle(dest, ndev, b):
    """The epoch loop's layout before the kernel: the stable rank of a ray
    among those with its owner by a cumsum of the one-hot owner, the
    selected lanes scattered into slot owner * b + rank, unsent ones into
    a spare slot that is cut off."""
    m, slots = dest.shape[0], ndev * b
    rank = torch.cumsum(
        (dest[:, None] == torch.arange(ndev)[None]).to(torch.int32), dim=0) - 1
    rank_i = torch.gather(rank, 1, torch.clamp(dest, max=ndev - 1)[:, None])[:, 0]
    sel = (dest < ndev) & (rank_i < b)
    slot = torch.where(sel, dest * b + rank_i, slots)
    send = torch.full((slots + 1,), m, dtype=torch.int64)
    send.scatter_(0, slot, torch.arange(m))
    return send[:slots]


@pytest.mark.parametrize("ndev,bucket,kind,m", CASES,
                         ids=[f"ndev{n}-b{b}-{k}-m{m}" for n, b, k, m in CASES])
def test_route_slots_equals_the_cumsum_layout(ndev, bucket, kind, m):
    b = max(m, 1) if bucket == "m" else bucket
    dest_np = _dest(kind, m, ndev, seed=ndev * 7919 + m)
    dest = torch.as_tensor(dest_np)
    send = route.route_slots(dest, ndev, b)
    assert send.dtype == torch.int64 and send.shape == (ndev * b,)
    assert torch.equal(send, _oracle(dest, ndev, b))
    # the invariants, from numpy alone
    got = send.numpy().reshape(ndev, b)
    seen = got[got < m]
    assert np.unique(seen).size == seen.size  # each sent lane once
    for o in range(ndev):
        lanes = np.nonzero(dest_np == o)[0]
        fill = min(lanes.size, b)
        # the owner's first b lanes in lane order, rising; then m
        np.testing.assert_array_equal(got[o, :fill], lanes[:fill])
        assert (np.diff(got[o, :fill]) > 0).all()
        assert (got[o, fill:] == m).all()
    sent = sum(min((dest_np == o).sum(), b) for o in range(ndev))
    assert seen.size == sent


@pytest.mark.parametrize("ndev,bucket,dtype,why", [
    (0, 4, torch.int64, "ndev"), (route.MAX_NDEV + 1, 4, torch.int64, "ndev"),
    (4, 0, torch.int64, "bucket"), (4, 4, torch.int32, "dest"),
])
def test_route_slots_refuses_what_the_kernel_does_not_take(ndev, bucket, dtype,
                                                           why):
    with pytest.raises(ValueError, match=why):
        route.route_slots(torch.zeros(8, dtype=dtype), ndev, bucket)


def test_route_slots_counts_no_launch_on_the_cpu():
    route.reset_launches()
    route.route_slots(torch.tensor([0, 1, 0, 2]), 2, 1)
    assert route.launches == {"route_slots_kernel": 0}


def test_epoch_loop_builds_each_round_through_route_slots(monkeypatch):
    """A world of one rank (the collectives are the identity there) with a
    bucket far smaller than the rays: every round asks `route_slots` for
    its layout once, with the world size and bucket, and gets the cumsum
    layout; the hits equal those of one bucket holding every ray."""
    scene = wisp_cloud(n_blobs=4, tris_per_blob=64, seed=5)
    mesh = Mesh(rank=0, size=1, device=torch.device("cpu"))
    monkeypatch.setattr(tep, "all_to_all", lambda x, mesh: x.clone())
    monkeypatch.setattr(tep, "all_reduce", lambda x, mesh: x)
    su = tep._insitu_setup(scene, mesh, n_domains=4)
    rs = np.random.RandomState(2)
    v = np.asarray(scene.vertices)
    n = 700
    o = torch.as_tensor(rs.uniform(v.min(0) - 1, v.max(0) + 1, (n, 3))
                        .astype(np.float32))
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True))
    tmin, tmax = torch.zeros(n), torch.full((n,), 1e30)
    calls = []
    real = route.route_slots

    def shim(dest, ndev, bucket):
        send = real(dest, ndev, bucket)
        calls.append((ndev, bucket, torch.equal(send, _oracle(dest, ndev,
                                                              bucket))))
        return send

    monkeypatch.setattr(route, "route_slots", shim)
    hits, rounds = {}, {}
    for bucket in (64, n):
        inter = tep._intersector(su, mesh, bucket, 64, su["tri_soa"])
        calls.clear()
        hits[bucket] = inter.intersect(o, d, tmin, tmax)
        rounds[bucket], exchanged = inter.drain_stats()
        assert calls == [(1, bucket, True)] * rounds[bucket]
        assert int(exchanged) > 0
    assert rounds[64] > rounds[n] > 0  # the small bucket holds rays over
    a, b = hits[64], hits[n]
    assert torch.equal(a.valid, b.valid) and bool(a.valid.any())
    assert torch.equal(a.prim, b.prim)
    assert torch.equal(a.t, b.t)
