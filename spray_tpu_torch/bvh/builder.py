"""Host-side BVH builder -> flat, wide, SoA arrays (numpy): a copy of
``spray_tpu/bvh/builder.py``, which gives the same arrays on the same inputs.

Output layout (branching factor B, default 8):
  child_lo     (N, B, 3) f32   child AABB min (+inf box for empty slots)
  child_hi     (N, B, 3) f32   child AABB max
  child_node   (N, B)    i32   >=0: child is internal node with this index
                               -1: empty slot
                               <=-2: leaf; first tri = -(v + 2) in the
                                     REORDERED tri array, count = child_count
  child_count  (N, B)    i32   leaf tri count (0 unless leaf)
  tri_order    (T,)      i32   permutation: new tri i = original tri_order[i]

Triangles are reordered so every leaf is a contiguous, leaf_size-padded run
that the traversal gathers as one block.  Padding slots hold triangle index
-1 (degenerate, never hit).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FlatBVH:
    child_lo: np.ndarray
    child_hi: np.ndarray
    child_node: np.ndarray
    child_count: np.ndarray
    tri_order: np.ndarray  # (T_padded,) int32, -1 = padding slot
    leaf_size: int
    world_lo: np.ndarray
    world_hi: np.ndarray

    @property
    def num_nodes(self):
        return self.child_lo.shape[0]

    @property
    def num_tris_padded(self):
        return self.tri_order.shape[0]


def _sah_split(centers, lo, hi, areas_half, num_bins):
    """Binned-SAH best split of tri index set.  Returns (axis, bin, mask) or None.

    centers: (M, 3) tri centroids; lo/hi: centroid bounds; areas_half unused
    placeholder for exactness (we use AABB surface area of bins).
    """
    best = (np.inf, None, None)
    ext = hi - lo
    for axis in range(3):
        if ext[axis] <= 1e-12:
            continue
        scale = num_bins * (1.0 - 1e-6) / ext[axis]
        b = ((centers[:, axis] - lo[axis]) * scale).astype(np.int32)
        b = np.clip(b, 0, num_bins - 1)
        counts = np.bincount(b, minlength=num_bins)
        # per-bin AABBs of tri bounds
        binlo = np.full((num_bins, 3), np.inf, np.float32)
        binhi = np.full((num_bins, 3), -np.inf, np.float32)
        np.minimum.at(binlo, b, centers)  # centroid bounds suffice for SAH cost
        np.maximum.at(binhi, b, centers)
        # prefix/suffix sweeps
        cl = np.cumsum(counts[:-1])
        cr = counts.sum() - cl
        llo = np.minimum.accumulate(binlo[:-1], axis=0)
        lhi = np.maximum.accumulate(binhi[:-1], axis=0)
        rlo = np.minimum.accumulate(binlo[1:][::-1], axis=0)[::-1]
        rhi = np.maximum.accumulate(binhi[1:][::-1], axis=0)[::-1]

        def area(alo, ahi):
            d = np.maximum(ahi - alo, 0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        cost = area(llo, lhi) * cl + area(rlo, rhi) * cr
        cost = np.where((cl == 0) | (cr == 0), np.inf, cost)
        k = int(np.argmin(cost))
        if cost[k] < best[0]:
            best = (cost[k], axis, k)
    if best[1] is None:
        return None
    _, axis, k = best
    scale = num_bins * (1.0 - 1e-6) / ext[axis]
    b = np.clip(((centers[:, axis] - lo[axis]) * scale).astype(np.int32), 0, num_bins - 1)
    return b <= k


@dataclasses.dataclass
class _BuildNode:
    tri_idx: np.ndarray  # indices into original tri arrays
    lo: np.ndarray
    hi: np.ndarray
    children: list  # list[_BuildNode] or [] for leaf


def _build_recursive(tri_idx, tlo, thi, centers, leaf_size, branching, num_bins):
    lo = tlo[tri_idx].min(0)
    hi = thi[tri_idx].max(0)
    node = _BuildNode(tri_idx, lo, hi, [])
    if len(tri_idx) <= leaf_size:
        return node
    # split into `branching` children: repeatedly split the largest child (by
    # tri count) with binned SAH until we have `branching` pieces.
    pieces = [tri_idx]
    while len(pieces) < branching:
        sizes = [len(p) for p in pieces]
        j = int(np.argmax(sizes))
        p = pieces[j]
        if len(p) <= leaf_size:
            break
        c = centers[p]
        clo, chi = c.min(0), c.max(0)
        mask = _sah_split(c, clo, chi, None, num_bins)
        if mask is None or mask.all() or not mask.any():
            # degenerate: median split on largest axis
            axis = int(np.argmax(chi - clo))
            order = np.argsort(c[:, axis], kind="stable")
            half = len(p) // 2
            left, right = p[order[:half]], p[order[half:]]
        else:
            left, right = p[mask], p[~mask]
        pieces[j : j + 1] = [left, right]
    if len(pieces) == 1:
        return node  # could not split: big leaf
    node.children = [
        _build_recursive(p, tlo, thi, centers, leaf_size, branching, num_bins)
        for p in pieces
    ]
    return node


def build_bvh(vertices, faces, leaf_size=16, branching=8, num_bins=16):
    """Build a FlatBVH over the triangle soup (host, numpy)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    t = vertices[faces.reshape(-1)].reshape(-1, 3, 3)
    ntri = len(t)
    if ntri == 0:
        raise ValueError("empty mesh")
    tlo = t.min(1)
    thi = t.max(1)
    centers = (tlo + thi) * 0.5
    root = _build_recursive(
        np.arange(ntri), tlo, thi, centers, leaf_size, branching, num_bins
    )

    # Flatten: BFS over internal nodes; leaves claim contiguous padded tri runs.
    # A root that is itself a leaf gets wrapped in a single internal node.
    if not root.children:
        wrapper = _BuildNode(root.tri_idx, root.lo, root.hi, [root])
        root = wrapper

    nodes = []  # internal nodes in BFS order
    queue = [root]
    while queue:
        n = queue.pop(0)
        nodes.append(n)
        for c in n.children:
            if c.children:
                queue.append(c)
    node_index = {id(n): i for i, n in enumerate(nodes)}

    nn = len(nodes)
    child_lo = np.full((nn, branching, 3), np.inf, np.float32)
    child_hi = np.full((nn, branching, 3), -np.inf, np.float32)
    child_node = np.full((nn, branching), -1, np.int32)
    child_count = np.zeros((nn, branching), np.int32)
    tri_order = []

    for i, n in enumerate(nodes):
        for j, c in enumerate(n.children):
            child_lo[i, j] = c.lo
            child_hi[i, j] = c.hi
            if c.children:
                child_node[i, j] = node_index[id(c)]
            else:
                start = len(tri_order)
                tri_order.extend(c.tri_idx.tolist())
                pad = (-len(c.tri_idx)) % leaf_size
                tri_order.extend([-1] * pad)
                child_node[i, j] = -(start + 2)
                child_count[i, j] = len(c.tri_idx)

    return FlatBVH(
        child_lo=child_lo,
        child_hi=child_hi,
        child_node=child_node,
        child_count=child_count,
        tri_order=np.asarray(tri_order, np.int32),
        leaf_size=leaf_size,
        world_lo=root.lo.astype(np.float32),
        world_hi=root.hi.astype(np.float32),
    )


def reordered_tri_arrays(vertices, faces, bvh):
    """Gather leaf-ordered triangle SoA (v0, e1, e2, orig_id) with padding.

    Padding slots get degenerate zero-area triangles at infinity (never hit)
    and orig_id -1.
    """
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    t = vertices[faces.reshape(-1)].reshape(-1, 3, 3)
    order = bvh.tri_order
    valid = order >= 0
    safe = np.where(valid, order, 0)
    tv = t[safe]
    far = np.float32(3e37)
    tv = np.where(valid[:, None, None], tv, far)
    v0 = tv[:, 0]
    e1 = np.where(valid[:, None], tv[:, 1] - tv[:, 0], 0.0).astype(np.float32)
    e2 = np.where(valid[:, None], tv[:, 2] - tv[:, 0], 0.0).astype(np.float32)
    orig = np.where(valid, order, -1).astype(np.int32)
    return v0.astype(np.float32), e1, e2, orig
