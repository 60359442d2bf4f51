"""Scene partitioning into spatial domains (host-side numpy): a copy of
``spray_tpu/domains/partition.py``, which gives the same arrays on the same
scene.

  - `partition_scene`: split a monolithic scene into D domains by recursive
    median splits over triangle centroids (balanced tri counts, compact
    boxes), each with its own BVH;
  - `build_domain_set`: the same from a given tri -> domain assignment.

Everything is padded to common shapes so the domain set stacks into
(D, ...) arrays, and each domain's slice is one page of the residency
slots (`residency/manager.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..bvh.builder import build_bvh, reordered_tri_arrays


@dataclasses.dataclass
class DomainSet:
    """Host-side stacked per-domain geometry + BVH arrays (numpy).

    All arrays have leading dim D.  Padding: tri slots with orig_id -1 are
    degenerate never-hit triangles; node slots beyond num_nodes have empty
    (+inf/-inf) child boxes.
    """

    aabb_lo: np.ndarray  # (D, 3)
    aabb_hi: np.ndarray  # (D, 3)
    # per-domain flattened BVH (padded to common node count)
    child_lo: np.ndarray  # (D, Nmax, B, 3)
    child_hi: np.ndarray  # (D, Nmax, B, 3)
    child_node: np.ndarray  # (D, Nmax, B)
    child_count: np.ndarray  # (D, Nmax, B)
    # per-domain leaf-ordered triangle SoA (padded to common tri count)
    v0: np.ndarray  # (D, Tmax, 3)
    e1: np.ndarray
    e2: np.ndarray
    orig_id: np.ndarray  # (D, Tmax) global tri id, -1 = padding
    leaf_size: int
    num_tris: np.ndarray  # (D,) real (unpadded) tri counts

    @property
    def num_domains(self):
        return self.aabb_lo.shape[0]

    @property
    def bytes_per_domain(self):
        per = 0
        for a in (self.child_lo, self.child_hi, self.child_node,
                  self.child_count, self.v0, self.e1, self.e2, self.orig_id):
            per += a[0].nbytes
        return per


def median_split_assign(centers, n_domains):
    """Recursive median split along the widest axis -> (T,) domain id per tri.

    n_domains need not be a power of two: splits proportionally.
    """
    ntri = len(centers)
    assign = np.zeros(ntri, np.int32)

    def rec(idx, dom_lo, dom_hi):
        k = dom_hi - dom_lo
        if k <= 1 or len(idx) == 0:
            assign[idx] = dom_lo
            return
        c = centers[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        k_left = k // 2
        # proportional split point keeps tri counts balanced
        cut = int(round(len(idx) * k_left / k))
        order = np.argsort(c[:, axis], kind="stable")
        rec(idx[order[:cut]], dom_lo, dom_lo + k_left)
        rec(idx[order[cut:]], dom_lo + k_left, dom_hi)

    rec(np.arange(ntri), 0, n_domains)
    return assign


def build_domain_set(scene, assign, n_domains, leaf_size=16,
                     branching=8):
    """Build per-domain BVHs from a tri→domain assignment and stack padded."""
    verts = np.asarray(scene.vertices, np.float32)
    faces = np.asarray(scene.faces, np.int64)

    per = []
    for d in range(n_domains):
        tri_ids = np.nonzero(assign == d)[0]
        if len(tri_ids) == 0:
            per.append(None)
            continue
        dfaces = faces[tri_ids]
        bvh = build_bvh(verts, dfaces, leaf_size=leaf_size, branching=branching)
        v0, e1, e2, local_orig = reordered_tri_arrays(verts, dfaces, bvh)
        # local ids -> global tri ids
        orig = np.where(local_orig >= 0, tri_ids[np.clip(local_orig, 0, None)],
                        -1).astype(np.int32)
        tv = verts[dfaces.reshape(-1)].reshape(-1, 3, 3)
        per.append({
            "lo": tv.min((0, 1)), "hi": tv.max((0, 1)),
            "child_lo": bvh.child_lo, "child_hi": bvh.child_hi,
            "child_node": bvh.child_node, "child_count": bvh.child_count,
            "v0": v0, "e1": e1, "e2": e2, "orig": orig,
            "ntri": len(tri_ids),
        })

    nmax = max(p["child_lo"].shape[0] for p in per if p is not None)
    tmax = max(p["v0"].shape[0] for p in per if p is not None)
    b = branching
    d_ = n_domains

    child_lo = np.full((d_, nmax, b, 3), np.inf, np.float32)
    child_hi = np.full((d_, nmax, b, 3), -np.inf, np.float32)
    child_node = np.full((d_, nmax, b), -1, np.int32)
    child_count = np.zeros((d_, nmax, b), np.int32)
    far = np.float32(3e37)
    v0 = np.full((d_, tmax, 3), far, np.float32)
    e1 = np.zeros((d_, tmax, 3), np.float32)
    e2 = np.zeros((d_, tmax, 3), np.float32)
    orig = np.full((d_, tmax), -1, np.int32)
    lo = np.full((d_, 3), np.inf, np.float32)
    hi = np.full((d_, 3), -np.inf, np.float32)
    ntris = np.zeros(d_, np.int32)

    for d, p in enumerate(per):
        if p is None:
            continue
        nn = p["child_lo"].shape[0]
        nt = p["v0"].shape[0]
        child_lo[d, :nn] = p["child_lo"]
        child_hi[d, :nn] = p["child_hi"]
        child_node[d, :nn] = p["child_node"]
        child_count[d, :nn] = p["child_count"]
        v0[d, :nt] = p["v0"]
        e1[d, :nt] = p["e1"]
        e2[d, :nt] = p["e2"]
        orig[d, :nt] = p["orig"]
        lo[d] = p["lo"]
        hi[d] = p["hi"]
        ntris[d] = p["ntri"]

    return DomainSet(
        aabb_lo=lo, aabb_hi=hi,
        child_lo=child_lo, child_hi=child_hi,
        child_node=child_node, child_count=child_count,
        v0=v0, e1=e1, e2=e2, orig_id=orig,
        leaf_size=leaf_size, num_tris=ntris,
    )


def partition_scene(scene, n_domains, leaf_size=16, branching=8):
    """Split a monolithic scene into a DomainSet by centroid median splits."""
    verts = np.asarray(scene.vertices, np.float32)
    faces = np.asarray(scene.faces, np.int64)
    tv = verts[faces.reshape(-1)].reshape(-1, 3, 3)
    centers = tv.mean(1)
    assign = median_split_assign(centers, n_domains)
    return build_domain_set(scene, assign, n_domains, leaf_size, branching)
