"""`brute.anyhit_serial_tests` (the tests the brute any-hit's serial order
needs: the bound of `brute_anyhit_kernel`) against a direct loop over the
rows, and the any-hit through the packed table (`tri12=`), on the CPU."""

import numpy as np
import pytest
import torch

from spray_tpu_torch.core import geom
from spray_tpu_torch.kernels import brute as tb

T = 600  # more than two of the kernel's 256-row tiles


def big_tri(x, y, z, size):
    """A triangle in the plane z covering a square of side `size` / 2 around
    (x, y): v0 at its lower left corner, edges along x and y."""
    return [x - size / 4, y - size / 4, z, size, 0.0, 0.0, 0.0, size, 0.0]


def scene():
    """(tri9, ids, rays, expected occlusion) with every case of the serial
    count: hits in the first row, only in the last, none, dead lanes, a
    window that ends before the hit, and rows with id < 0 in front of every
    ray between the hits."""
    rs = np.random.RandomState(3)
    tri9 = np.zeros((T, 9), np.float32)
    # filler: small triangles far off every ray's path
    tri9[:, 0:3] = rs.uniform(30.0, 40.0, (T, 3))
    tri9[:, 3:9] = rs.uniform(-1.0, 1.0, (T, 6))
    ids = np.arange(T, dtype=np.int32)
    tri9[0] = big_tri(10.0, 0.0, 0.0, 4.0)  # group A, the first row
    tri9[T - 1] = big_tri(-10.0, 0.0, 0.0, 4.0)  # group B, the last row
    # group E: a row with id < 0, then the real one, then one more real
    tri9[40] = big_tri(0.0, -10.0, 0.5, 4.0)
    ids[40] = -1
    tri9[300] = big_tri(0.0, -10.0, 0.0, 4.0)
    tri9[450] = big_tri(0.0, -10.0, -1.0, 4.0)
    # rows with id < 0 in front of every ray, between the hits
    front = [1, 5, 255, 256, 257, 299, T - 2]
    for k in front:
        tri9[k] = big_tri(0.0, 0.0, 1.0, 80.0)
    ids[front] = -1
    ids[[77, 501]] = np.iinfo(np.int32).min
    centres = {"A": (10.0, 0.0), "B": (-10.0, 0.0), "C": (0.0, 10.0),
               "E": (0.0, -10.0), "dead": (10.0, 0.0)}
    o, d, tmin, tmax, want = [], [], [], [], []
    for name, (x, y) in centres.items():
        m = 40
        oo = np.zeros((m, 3), np.float32)
        oo[:, 0] = x + rs.uniform(-0.3, 0.3, m)
        oo[:, 1] = y + rs.uniform(-0.3, 0.3, m)
        oo[:, 2] = 3.0
        dd = np.concatenate([rs.uniform(-0.01, 0.01, (m, 2)), -np.ones((m, 1))],
                            axis=1)
        dd /= np.linalg.norm(dd, axis=1, keepdims=True)
        lo = np.zeros(m, np.float32)
        hi = np.full(m, np.inf, np.float32)
        occ = np.full(m, name in "ABE")
        if name == "A":
            hi[::4] = 2.0  # the window ends before the hit at t = 3
            occ[::4] = False
        if name == "dead":
            hi[0::4] = 0.0
            hi[1::4] = -1.0
            lo[2::4] = np.nan
            hi[3::4] = np.nan
            occ[:] = False
        o.append(oo)
        d.append(dd)
        tmin.append(lo)
        tmax.append(hi)
        want.append(occ)
    rays = [torch.as_tensor(np.concatenate(x).astype(np.float32))
            for x in (o, d, tmin, tmax)]
    return (torch.as_tensor(tri9), torch.as_tensor(ids), rays,
            np.concatenate(want).astype(np.int32))


def serial_by_loop(tri9, ids, o, d, tmin, tmax):
    """Tests per ray, one row at a time, as the serial any-hit does them
    (each ray's row hits computed first, against the whole table)."""
    out = np.zeros(o.shape[0], np.int64)
    real = (ids >= 0).tolist()
    for i in range(o.shape[0]):
        if not bool(tmax[i] > tmin[i]):
            continue
        t, _, _, ok = geom.moller_trumbore(o[i], d[i], tri9[:, 0:3],
                                           tri9[:, 3:6], tri9[:, 6:9])
        hits = (ok & (t > tmin[i]) & (t < tmax[i])).tolist()
        for row in range(tri9.shape[0]):
            if not real[row]:
                continue
            out[i] += 1
            if hits[row]:
                break
    return out


@pytest.fixture(scope="module")
def case():
    tri9, ids, rays, want = scene()
    return tri9, ids, rays, want, serial_by_loop(tri9, ids, *rays)


def test_serial_tests_match_a_loop_over_rows(case):
    tri9, ids, rays, want, loop = case
    got = tb.anyhit_serial_tests(tri9, ids, *rays).numpy()
    np.testing.assert_array_equal(got, loop)
    # each case by hand: 40 rays a group, A, B, C, E, dead in that order
    real = int((ids >= 0).sum())
    a, b, c, e, dead = got.reshape(5, 40)
    assert (a[1::4] == 1).all() and (a[::4] == real).all()  # first row
    assert (b == real).all() and (c == real).all()  # last row; no hit
    assert (e == int((ids[:301] >= 0).sum())).all()  # through row 300
    assert (dead == 0).all()
    occ = tb.brute_anyhit_reference(tri9, ids, *rays).numpy()
    np.testing.assert_array_equal(occ, want)


def test_serial_tests_of_an_empty_table():
    rays = (torch.zeros(3, 3), torch.ones(3, 3), torch.zeros(3), torch.ones(3))
    got = tb.anyhit_serial_tests(torch.zeros(0, 9),
                                 torch.zeros(0, dtype=torch.int32), *rays)
    assert got.tolist() == [0, 0, 0]


def test_anyhit_through_the_packed_table(case):
    tri9, ids, rays, want, _ = case
    tri12 = tb.pack_table(tri9, ids)
    got = tb.brute_anyhit(tri9, ids, *rays, tri12=tri12)
    assert torch.equal(got, tb.brute_anyhit_reference(tri9, ids, *rays))
    np.testing.assert_array_equal(got.numpy(), want)
    for bad in (tri12[:, :11].contiguous(), tri12[:-1].contiguous(),
                tri12.double()):
        with pytest.raises(ValueError):
            tb.brute_anyhit(tri9, ids, *rays, tri12=bad)
