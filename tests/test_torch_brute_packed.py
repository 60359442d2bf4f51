"""The packed table `brute_nearest_kernel` reads (`brute.pack_table`: rows
of three 16-byte vectors, v0 | e1 | e2 with the id's bits in the twelfth
word), on the CPU: it round-trips the (tri9, ids) table bit for bit, lays
each vector where the kernel loads it, and a row with a negative id never
hits through it."""

import numpy as np
import pytest
import torch

from spray_tpu_torch.kernels import brute as tb


def unpack_table(tri12):
    """(tri9, ids) of a `pack_table` table, bit for bit."""
    tri9 = tri12[:, [0, 1, 2, 4, 5, 6, 8, 9, 10]]
    return tri9, tri12[:, 11].contiguous().view(torch.int32)


def table(n, seed):
    """n rows of triangles near the unit box, with -0.0, +-inf and a NaN
    among the floats and negative ids (-1 and INT32_MIN, whose bits are NaN
    patterns as floats) among the ids."""
    rs = np.random.RandomState(seed)
    tri9 = rs.uniform(-1.0, 1.0, (n, 9)).astype(np.float32)
    tri9[0, 0] = -0.0
    tri9[1, 4] = np.inf
    tri9[2, 8] = -np.inf
    tri9[3, 2] = np.nan
    ids = np.arange(n, dtype=np.int32)
    ids[4::5] = -1
    ids[7] = np.iinfo(np.int32).min
    return torch.as_tensor(tri9), torch.as_tensor(ids)


def test_pack_table_round_trips_bit_for_bit():
    tri9, ids = table(61, 0)
    tri12 = tb.pack_table(tri9, ids)
    assert tri12.shape == (61, 12) and tri12.dtype == torch.float32
    assert tri12.is_contiguous()
    back9, back_ids = unpack_table(tri12)
    assert back_ids.dtype == torch.int32
    np.testing.assert_array_equal(back9.numpy().view(np.uint32),
                                  tri9.numpy().view(np.uint32))
    np.testing.assert_array_equal(back_ids.numpy(), ids.numpy())
    # the three vectors the kernel loads: (v0, 0), (e1, 0), (e2, id)
    vec = tri12.view(61, 3, 4).numpy()
    for j in range(3):
        np.testing.assert_array_equal(vec[:, j, :3].view(np.uint32),
                                      tri9.numpy()[:, 3 * j:3 * j + 3].view(np.uint32))
    assert (vec[:, :2, 3].view(np.uint32) == 0).all()
    np.testing.assert_array_equal(vec[:, 2, 3].view(np.int32), ids.numpy())
    # the intersector keeps the same table, packed once; a wrong one is refused
    isect = tb.PallasBruteIntersector.from_arrays(tri9.numpy(), ids.numpy(),
                                                  device="cpu")
    assert torch.equal(isect.tri12.view(torch.int32), tri12.view(torch.int32))
    rays = (torch.zeros(4, 3), torch.ones(4, 3), torch.zeros(4), torch.ones(4))
    with pytest.raises(ValueError):
        tb.brute_nearest(tri9, ids, *rays, tri12=tri12[:, :11].contiguous())


def test_negative_ids_never_hit_through_the_packed_table():
    """Rows with a negative id are transparent: the nearest hit through the
    packed table equals the one through the table without them, and no ray
    reports a negative id, though those rows lie in front of every ray."""
    rs = np.random.RandomState(1)
    n_tris, n = 40, 200
    tri9 = np.zeros((n_tris, 9), np.float32)
    tri9[:, 0:3] = rs.uniform(-0.5, 0.5, (n_tris, 3))
    tri9[:, 3:6] = rs.uniform(-1.0, 1.0, (n_tris, 3))
    tri9[:, 6:9] = rs.uniform(-1.0, 1.0, (n_tris, 3))
    ids = np.arange(100, 100 + n_tris, dtype=np.int32)
    # every fourth row: a large triangle in front of every ray, id < 0
    tri9[::4] = [-9.0, -9.0, 2.0, 30.0, 0.0, 0.0, 0.0, 30.0, 0.0]
    ids[::4] = -1
    o = np.tile(np.float32([0.0, 0.0, 3.0]), (n, 1))
    o[:, :2] = rs.uniform(-0.3, 0.3, (n, 2))
    d = np.concatenate([rs.uniform(-0.4, 0.4, (n, 2)), -np.ones((n, 1))], axis=1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[::9] = 0.0  # dead lanes
    rays = [torch.as_tensor(x) for x in (o, d, tmin, tmax)]
    tri12 = tb.pack_table(torch.as_tensor(tri9), torch.as_tensor(ids))
    got = tb.brute_nearest(*unpack_table(tri12), *rays)
    keep = ids >= 0
    ref = tb.brute_nearest(torch.as_tensor(tri9[keep]), torch.as_tensor(ids[keep]),
                           *rays)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert (got[1] >= 0).any() and not (got[1] == -1)[tmax > 0].all()
    assert ((got[1] == -1) | (got[1] >= 100)).all()
    # the negative rows do lie in front of the rays: with their ids made
    # positive they take every live ray's hit
    ids_pos = np.where(ids < 0, 7, ids).astype(np.int32)
    front = tb.brute_nearest(torch.as_tensor(tri9), torch.as_tensor(ids_pos), *rays)
    assert (front[1][tmax > 0] == 7).all()
    assert (front[0] < got[0])[tmax > 0].all()
