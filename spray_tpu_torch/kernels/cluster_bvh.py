"""Cluster BVH: host-side build of the traversal kernels' pages.

Numpy copy of the Morton builder of ``spray_tpu/kernels/cluster_bvh.py``: a
shallow 8-wide SAH tree over clusters of C <= 128 triangles.  Each triangle
is stored as a world->unit-triangle affine transform (Woop style); a cluster
packs those as a (4, 3C) matrix W with component-major column blocks
[u | v | w], so for a ray [o, 1] / [d, 0]

    ou = [o,1] . W[:, i],  ov = [o,1] . W[:, C+i],  ow = [o,1] . W[:, 2C+i]

and t = -ow/dw, u = ou + t du, v = ov + t dv.  Degenerate and padding
triangles get a transform that never hits (dw = 0).

The transforms and the Morton order come from the native library
(``spray_tpu_torch/native``), as the reference's do; without g++ the numpy
fallbacks compute the same formulas and equal it bit for bit, so the pages
do not depend on whether a compiler exists.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native

CLUSTER = 128  # tris per cluster; the keyed decode packs the row in 7 bits


@dataclasses.dataclass
class ClusterBVH:
    """Flat page arrays of one domain."""

    bounds: np.ndarray  # (Nn, 8, 6) f32: per child [lox,loy,loz,hix,hiy,hiz]
    meta: np.ndarray  # (Nn, 8) i32: >=0 internal child; -1 empty;
    #                   <= -2 leaf -> cluster id = -(v + 2)
    w: np.ndarray  # (Nc, 4, 3*C) f32 transform blocks [u | v | w]
    tri_ids: np.ndarray  # (Nc, C) i32 tri ids (-1 padding)
    world_lo: np.ndarray
    world_hi: np.ndarray

    @property
    def num_nodes(self):
        return self.bounds.shape[0]

    @property
    def num_clusters(self):
        return self.w.shape[0]


def _cross(x, y):
    """Row-wise cross product, each component as builder.cpp's cross3."""
    return np.stack([x[:, 1] * y[:, 2] - x[:, 2] * y[:, 1],
                     x[:, 2] * y[:, 0] - x[:, 0] * y[:, 2],
                     x[:, 0] * y[:, 1] - x[:, 1] * y[:, 0]], axis=-1)


def tri_transforms(v0, e1, e2):
    """(T, 4, 3) per-tri affine blocks: rows 0-2 = A (=[e1 e2 n]^-1),
    row 3 = -A v0.  Degenerate tris -> never-hit transform.

    builder.cpp's formula in float64, operation for operation: the rows of
    A are the adjugate's rows (b x c, c x a, a x b) over the determinant,
    cast to float32 at the end.  It equals the native library bit for bit.
    (The reference's own fallback inverts in float32 with np.linalg.inv,
    which rounds differently from its native library; the port does not
    copy that.)"""
    a = np.asarray(e1, np.float64)
    b = np.asarray(e2, np.float64)
    p = np.asarray(v0, np.float64)
    c = _cross(a, b)  # unnormalized normal = third column
    bxc = _cross(b, c)
    det = a[:, 0] * bxc[:, 0] + a[:, 1] * bxc[:, 1] + a[:, 2] * bxc[:, 2]
    bad = np.abs(det) < 1e-18
    out = np.empty((len(a), 4, 3), np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):  # degenerate rows
        rows = np.stack([bxc, _cross(c, a), c], axis=1) * (1.0 / det)[:, None, None]
        out[:, 0:3, :] = np.transpose(rows, (0, 2, 1))  # out[:, r, k] = A[k, r]
        out[:, 3, :] = -(rows[:, :, 0] * p[:, None, 0]
                         + rows[:, :, 1] * p[:, None, 1]
                         + rows[:, :, 2] * p[:, None, 2])
    # never-hit for degenerate: A=0, trans=(0,0,1) => O'w=1, D'w=0
    out[bad] = 0.0
    out[bad, 3, 2] = 1.0
    return out


def build_clusters(vertices, faces, cluster=CLUSTER):
    """Morton-order tris into `cluster`-sized groups in the page layout.

    Returns (w (Nc,4,3C) f32, tri_ids (Nc,C) i32, clo (Nc,3), chi (Nc,3)).
    """
    assert cluster <= CLUSTER
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    tv = vertices[faces.reshape(-1)].reshape(-1, 3, 3)
    ntri = len(tv)
    tlo = tv.min(1)
    thi = tv.max(1)
    order = native.morton_order(tlo, thi)  # C++ fast path
    if order is None:
        order = _morton_order(tlo, thi)
    tp = -(-ntri // cluster) * cluster
    perm = np.concatenate([order, np.full(tp - ntri, -1, np.int64)])
    nc = tp // cluster

    valid = perm >= 0
    safe = np.where(valid, perm, 0)
    t = tv[safe]
    v0 = np.where(valid[:, None], t[:, 0], 0.0).astype(np.float32)
    e1 = np.where(valid[:, None], t[:, 1] - t[:, 0], 0.0).astype(np.float32)
    e2 = np.where(valid[:, None], t[:, 2] - t[:, 0], 0.0).astype(np.float32)
    tf = native.tri_transforms(v0, e1, e2)  # C++ fast path
    if tf is None:
        tf = tri_transforms(v0, e1, e2)
    tf = tf.reshape(nc, cluster, 4, 3)
    w = np.transpose(tf, (0, 2, 3, 1)).reshape(nc, 4, 3 * cluster)
    ids = np.where(valid, perm, -1).astype(np.int32).reshape(nc, cluster)

    plo = np.where(valid[:, None], tlo[safe], np.inf).reshape(nc, cluster, 3)
    phi = np.where(valid[:, None], thi[safe], -np.inf).reshape(nc, cluster, 3)
    clo = plo.min(1)
    chi = phi.max(1)
    return (
        np.ascontiguousarray(w.astype(np.float32)), ids,
        clo.astype(np.float32), chi.astype(np.float32),
    )


def _sah_split(clo, chi, ids, num_bins=16):
    """Best binned-SAH binary split of a cluster id set -> (left, right).
    Falls back to a median split when every binning is degenerate."""
    n = len(ids)
    c = (clo[ids] + chi[ids]) * 0.5

    def area(lo, hi):
        d = np.maximum(hi - lo, 0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    best = None  # (cost, left_mask)
    for axis in range(3):
        cmin, cmax = c[:, axis].min(), c[:, axis].max()
        ext = cmax - cmin
        if ext <= 1e-12:
            continue
        b = np.minimum(
            ((c[:, axis] - cmin) / ext * num_bins).astype(np.int64),
            num_bins - 1,
        )
        counts = np.bincount(b, minlength=num_bins)
        blo = np.full((num_bins, 3), np.inf)
        bhi = np.full((num_bins, 3), -np.inf)
        np.minimum.at(blo, b, clo[ids])
        np.maximum.at(bhi, b, chi[ids])
        lo_l = np.minimum.accumulate(blo, axis=0)
        hi_l = np.maximum.accumulate(bhi, axis=0)
        lo_r = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
        hi_r = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
        n_l = np.cumsum(counts)
        n_r = n - n_l
        # split after bin k: left = bins [0..k], right = bins [k+1..]
        cost = np.where(
            (n_l[:-1] > 0) & (n_r[:-1] > 0),
            area(lo_l[:-1], hi_l[:-1]) * n_l[:-1]
            + area(lo_r[1:], hi_r[1:]) * n_r[:-1],
            np.inf,
        )
        k = int(np.argmin(cost))
        if np.isfinite(cost[k]) and (best is None or cost[k] < best[0]):
            best = (cost[k], b <= k)
    if best is None:
        half = n // 2
        return ids[:half], ids[half:]
    _, lmask = best
    return ids[lmask], ids[~lmask]


def _split8(clo, chi, ids, num_bins):
    """Recursive binary SAH to depth 3 -> up to 8 child id sets."""
    parts = [ids]
    for _ in range(3):
        nxt = []
        for p in parts:
            if len(p) <= 1:
                nxt.append(p)
            else:
                nxt.extend(_sah_split(clo, chi, p, num_bins))
        if len(nxt) == len(parts):
            break
        parts = nxt
    return [p for p in parts if len(p)]


def _build_sah_tree(clo, chi, branching=8, num_bins=16):
    """8-wide SAH tree over cluster AABBs, nodes numbered in BFS order.
    Each node splits its cluster set into up to 8 children by recursive
    binary binned-SAH; leaves are single clusters."""
    nc = clo.shape[0]
    node_children = []  # node id -> list of ("leaf", cid) | ("node", nid)
    queue = [np.arange(nc, dtype=np.int64)]  # BFS: node id == dequeue order
    sets = []
    while queue:
        ids = queue.pop(0)
        sets.append(ids)
        ch = []
        if len(ids) <= 8:
            ch = [("leaf", int(cid)) for cid in ids]
        else:
            for part in _split8(clo, chi, ids, num_bins):
                if len(part) == 1:
                    ch.append(("leaf", int(part[0])))
                else:
                    # child node id = its eventual BFS dequeue position
                    ch.append(("node", len(sets) + len(queue)))
                    queue.append(part)
        node_children.append(ch)

    nn = len(node_children)
    bounds = np.zeros((nn, 8, 6), np.float32)
    bounds[:, :, 0:3] = np.inf  # empty slots never hit
    bounds[:, :, 3:6] = -np.inf
    meta = np.full((nn, 8), -1, np.int32)
    for i, ch in enumerate(node_children):
        for j, (kind, v) in enumerate(ch):
            if kind == "leaf":
                bounds[i, j, 0:3] = clo[v]
                bounds[i, j, 3:6] = chi[v]
                meta[i, j] = -(v + 2)
            else:
                sub = sets[v]
                bounds[i, j, 0:3] = clo[sub].min(0)
                bounds[i, j, 3:6] = chi[sub].max(0)
                meta[i, j] = v
    return bounds, meta


def morton3(x, y, z, bits=10):
    """Interleave 3x `bits`-bit ints -> Morton codes (vectorized numpy)."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    return (
        spread(x) | (spread(y) << np.uint64(1)) | (spread(z) << np.uint64(2))
    )


def _morton_order(tlo, thi, bits=10):
    """Triangle permutation by Morton code of the centroid (vectorized)."""
    c = (tlo + thi) * 0.5
    lo = c.min(0)
    ext = np.maximum(c.max(0) - lo, 1e-12)
    q = np.minimum(
        ((c - lo) / ext * ((1 << bits) - 1)).astype(np.uint32),
        (1 << bits) - 1,
    )
    codes = morton3(q[:, 0], q[:, 1], q[:, 2], bits)
    return np.argsort(codes, kind="stable")


def build_cluster_bvh(vertices, faces, branching=8, num_bins=16,
                      cluster=CLUSTER):
    """Build the cluster BVH with the Morton cluster builder and an 8-wide
    SAH tree over the clusters.  (The reference's other builders, its
    triangle-SAH `builder="sah"` and Morton-range `tree="range"`, have no
    caller there and are not copied.)"""
    w, ids, clo, chi = build_clusters(vertices, faces, cluster)
    bounds, meta = _build_sah_tree(clo, chi, branching, num_bins)
    return ClusterBVH(
        bounds=bounds, meta=meta, w=w, tri_ids=ids,
        world_lo=clo.min(0).astype(np.float32),
        world_hi=chi.max(0).astype(np.float32),
    )
