"""Multi-domain intersector over the CUDA cluster kernels.

Counterpart of ``spray_tpu/kernels/multidomain.py``: the scene is split into
domains of at most MAX_DOMAIN_TRIS triangles, each with its own cluster BVH,
stacked to identical padded page shapes.  A wavefront is stably re-ordered
(`_live_partition`: live rays grouped by direction octant and origin-Morton
cell, dead lanes last), cut into packets, and each packet gets its
front-to-back domain list (`_packet_domain_order`).  Every ``routed`` mode
of the reference is here:

  - ``"fused"`` (default): `traverse.nearest` walks every listed domain per
    ray in ONE launch; `occluded` is one `traverse.anyhit` launch over the
    whole list (`_routed_anyhit_fused`);
  - ``"grid"``, ``"global"``, ``True``: D rounds; in round r each packet
    traces domain ``order[:, r]`` through `traverse.nearest_slot` with the
    carried best t as its window, then min-combines; any-hit runs
    `traverse.anyhit` on one-entry lists per round.  The three differ in
    the reference only in how packets are moved for the TPU's page DMAs
    (per-round data sort, one global sort, a grid permutation with a
    collapsed dead tail); on the card rays stay in place and the modes
    share one per-round loop, selectable so results can be held equal;
  - ``False``: every domain over every packet, in domain order.

The TPU path's grid schedules (`_bucket_perm`, the rounds-major schedule,
the dead-tail collapse) and its pre-stacked bf16 pages are TPU artifacts the
port drops: it keeps the compact f32 (4, 3C) pages.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..core.device import resolve_device
from ..core.types import Hits
from ..domains.partition import median_split_assign
from . import traverse
from .cluster_bvh import CLUSTER, ClusterBVH, build_cluster_bvh
from .common import pad_rays
from .traverse import PACKET

MAX_DOMAIN_TRIS = 1 << 17  # ~131K tris per domain (the reference's rule)
MORTON_BITS = 4  # per axis -> 12-bit origin key in _live_partition


def split_for_vmem(scene, max_tris=MAX_DOMAIN_TRIS):
    """Domain count of the reference: ceil(tris / 131072)."""
    ntri = int(np.asarray(scene.faces).shape[0])
    return max(1, -(-ntri // max_tris))


def _pad0(a, n):
    if a.shape[0] >= n:
        return a
    pad = np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad])


def _pad_const(a, n, v):
    if a.shape[0] >= n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], v, a.dtype)
    return np.concatenate([a, pad])


def build_cluster_domains(scene, n_domains=None, cluster=None):
    """Partition the scene and build one ClusterBVH per domain, stacked to
    identical padded shapes (host numpy).

    Returns dict: bounds (D,Nn,8,6), meta (D,Nn,8), w (D,Nc,4,3C),
    tri_ids (D,Nc*C) GLOBAL ids, aabb (D,6).  Padded nodes have zero bounds
    and meta -1; padded clusters have zero (never-hit) transforms.
    """
    verts = np.asarray(scene.vertices, np.float32)
    faces = np.asarray(scene.faces, np.int64)
    if cluster is None:
        cluster = CLUSTER
    if n_domains is None:
        n_domains = split_for_vmem(scene)
    tv = verts[faces.reshape(-1)].reshape(-1, 3, 3)
    centers = tv.mean(1)
    if n_domains == 1:
        assign = np.zeros(len(centers), np.int32)
    else:
        assign = median_split_assign(centers, n_domains)
    cbvhs = []
    aabbs = []
    for d in range(n_domains):
        ids = np.nonzero(assign == d)[0]
        if len(ids) == 0:
            # zero-cluster placeholder page: one root with no valid child,
            # all-zero transforms, and a far point box rays never enter
            far = np.float32(2e30)
            cbvhs.append(ClusterBVH(
                bounds=np.concatenate([
                    np.full((1, 8, 3), np.inf, np.float32),
                    np.full((1, 8, 3), -np.inf, np.float32),
                ], axis=2),
                meta=np.full((1, 8), -1, np.int32),
                w=np.zeros((1, 4, 3 * cluster), np.float32),
                tri_ids=np.full((1, cluster), -1, np.int32),
                world_lo=np.full(3, far, np.float32),
                world_hi=np.full(3, far, np.float32),
            ))
            aabbs.append(np.full(6, far, np.float32))
            continue
        cbvh = build_cluster_bvh(verts, faces[ids], cluster=cluster)
        local = cbvh.tri_ids
        cbvh.tri_ids = np.where(
            local >= 0, ids[np.clip(local, 0, None)], -1
        ).astype(np.int32)
        cbvhs.append(cbvh)
        dv = verts[faces[ids].reshape(-1)]
        aabbs.append(np.concatenate([dv.min(0), dv.max(0)]))
    nn_max = max(c.bounds.shape[0] for c in cbvhs)
    nc_max = max(c.w.shape[0] for c in cbvhs)
    return {
        "aabb": np.stack(aabbs).astype(np.float32),
        "bounds": np.stack([_pad0(c.bounds, nn_max) for c in cbvhs]),
        "meta": np.stack([_pad_const(c.meta, nn_max, -1) for c in cbvhs]),
        "w": np.stack([_pad0(c.w, nc_max) for c in cbvhs]),
        "tri_ids": np.stack(
            [_pad_const(c.tri_ids, nc_max, -1).reshape(-1) for c in cbvhs]
        ),
    }


def _morton_origin(o, lo, hi, bits=MORTON_BITS):
    """Per-ray Morton code of the origin quantized over the scene box."""
    scale = float(1 << bits) / torch.clamp(hi - lo, min=1e-12)
    # clamping before the cast equals the reference's cast-then-clip on every
    # finite value and keeps far-away origins out of int overflow
    q = torch.clamp((o - lo) * scale, 0, (1 << bits) - 1).to(torch.int32)

    def spread(v):  # 3-bit spread: abc -> a__b__c
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _live_partition(win, d, o, world_lo, world_hi):
    """Stable permutation for packet formation: live rays grouped by
    (direction octant, origin-Morton cell), dead lanes (win <= 0) last.
    Returns (perm, inv): trace o[perm] etc, then result[inv] restores the
    input order.  Equals the reference's permutation exactly."""
    live = win > 0
    octant = (
        (d[:, 0] > 0).to(torch.int32)
        | ((d[:, 1] > 0).to(torch.int32) << 1)
        | ((d[:, 2] > 0).to(torch.int32) << 2)
    )
    shift = 3 * MORTON_BITS
    m = _morton_origin(o, world_lo, world_hi)
    key = torch.where(live, (octant << shift) | m,
                      torch.full_like(m, 1 << (shift + 3)))
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    return perm, inv


def _packet_domain_order(o, d, tmin, tmax, dom_aabb, packet):
    """Per-packet front-to-back domain order.

    o, d (P*packet, 3), tmin, tmax (P*packet,); dom_aabb (D, 6).  Returns
    (order, entry_sorted): order (P, D) int32 domain ids sorted stably by
    the packet's min entry distance, -1 where no ray of the packet overlaps
    the domain (so every -1 sits after the listed domains).
    """
    p = o.shape[0] // packet
    o3 = o.reshape(p, packet, 3)
    d3 = d.reshape(p, packet, 3)
    lo_w = tmin.reshape(p, packet)
    hi_w = tmax.reshape(p, packet)
    eps = 1e-12
    inv = 1.0 / torch.where(torch.abs(d3) > eps, d3, torch.full_like(d3, eps))
    entries = []
    for box in dom_aabb:  # D is small: no (D, P, packet) intermediate
        with trace.span("spray.glue.order"):
            t0 = (box[0:3] - o3) * inv
            t1 = (box[3:6] - o3) * inv
            tn = torch.maximum(torch.minimum(t0, t1).amax(dim=2), lo_w)
            tf = torch.minimum(torch.maximum(t0, t1).amin(dim=2), hi_w)
            ent = torch.where(tn <= tf, tn, torch.full_like(tn, float("inf")))
            entries.append(ent.amin(dim=1))
    with trace.span("spray.glue.order"):
        entry = torch.stack(entries, dim=1)  # (P, D)
        order = torch.argsort(entry, dim=1, stable=True)
        entry_sorted = torch.gather(entry, 1, order)
        order = torch.where(torch.isfinite(entry_sorted), order,
                            torch.full_like(order, -1))
        return order.to(torch.int32).contiguous(), entry_sorted


ROUTED_MODES = ("fused", "grid", "global", True, False)


def _round_buckets(win, dom, packet):
    """(P,) i32 bucket map of one round: the packet's domain, or -1 where
    the packet has no domain this round or no lane with a live window
    (the reference's ``live_buckets(win_pk, dom)``)."""
    any_live = (win.view(-1, packet) > 0).any(dim=1)
    return torch.where(any_live & (dom >= 0), dom, -1).to(torch.int32)


class MultiDomainClusterIntersector:
    """Drop-in intersector: D per-domain cluster BVHs traversed front to
    back by the CUDA kernels (or their plain versions on the CPU).

    routed: "fused" (default; one launch for all domain rounds), "grid",
    "global" or True (one launch per round; equal results), False (every
    domain over every packet) -- see the module docstring.
    """

    def __init__(self, scene, n_domains=None, packet=PACKET, cluster=None,
                 device=None, routed="fused"):
        device = resolve_device(device)
        self._init(scene, build_cluster_domains(scene, n_domains, cluster),
                   packet, device, routed)

    @classmethod
    def from_pages(cls, scene, pages, packet=PACKET, device=None,
                   routed="fused"):
        """Intersector over pages built elsewhere: the numpy dict of
        ``build_cluster_domains`` (this package's or the reference's)."""
        obj = cls.__new__(cls)
        obj._init(scene, pages, packet, resolve_device(device), routed)
        return obj

    def _init(self, scene, pages, packet, device, routed="fused"):
        def dev(x, dtype):
            return torch.as_tensor(np.ascontiguousarray(x, dtype), device=device)

        if routed not in ROUTED_MODES:
            raise ValueError(f"routed: want one of {ROUTED_MODES}, got {routed!r}")
        self.routed = routed
        self.device = device
        self.packet = packet
        aabb = np.asarray(pages["aabb"], np.float32)
        self.dom_aabb = dev(aabb, np.float32)
        self.world_lo = dev(aabb[:, 0:3].min(0), np.float32)
        self.world_hi = dev(aabb[:, 3:6].max(0), np.float32)
        self.n_domains = aabb.shape[0]
        self.bounds = dev(pages["bounds"], np.float32)
        self.meta = dev(pages["meta"], np.int32)
        self.w = dev(pages["w"], np.float32)
        self.tri_ids = dev(np.asarray(pages["tri_ids"]).reshape(-1), np.int64)
        self.per_dom = self.w.shape[1] * (self.w.shape[3] // 3)  # codes per domain
        self.depth = traverse.tree_depth(pages["meta"])
        self.v0, self.e1, self.e2 = traverse.tri_soa_from_scene(scene, device)

    def _args(self, o, d, tmin, tmax):
        """Packet-ordered padded rays + their domain lists."""
        with trace.span("spray.glue.partition"):
            perm, inv = _live_partition(tmax, d, o, self.world_lo,
                                        self.world_hi)
            rays = pad_rays(o[perm], d[perm], tmin[perm], tmax[perm],
                            self.packet)
        order, _ = _packet_domain_order(*rays, self.dom_aabb, self.packet)
        return (order, *rays, self.bounds, self.meta, self.w, self.packet,
                self.depth), inv

    def _hits(self, o, d, tmax, args, inv, t, code):
        """Hits in the caller's ray order from the packet-ordered (t, code)
        of `nearest` on `_args`' output (code: global, dom * per_dom +
        domain-local)."""
        n = o.shape[0]
        prim = torch.where(
            code >= 0, self.tri_ids[torch.clamp(code, min=0).long()], -1
        ).to(torch.int32)
        bt = torch.where(prim >= 0, t, args[4])  # no commit: the ray's tmax
        bt, bp = bt[:n][inv], prim[:n][inv]
        t, u, v, valid = traverse.attrs_for_prims(
            self.v0, self.e1, self.e2, bp, o, d, bt, tmax
        )
        return Hits(t=torch.where(valid, t, tmax), prim=bp, u=u, v=v,
                    valid=valid)

    def _round_lists(self, order):
        """The (P,) domain of every packet for each launch of a per-round
        mode: the columns of its front-to-back list, or with routed=False
        every domain in turn."""
        if not self.routed:
            return [torch.full_like(order[:, 0], dom)
                    for dom in range(self.n_domains)]
        return [order[:, r].contiguous() for r in range(order.shape[1])]

    def _rounds_nearest(self, args):
        """Per-round nearest: one `nearest_slot` launch per round with the
        carried best t baked into the window, min-combined with
        ``(code >= 0) & (t < best_t)``.  Returns packet-ordered (t, global
        code) as `traverse.nearest` does."""
        order, o, d, tmin, tmax, *pages = args
        best_t = tmax.clone()
        best_code = torch.full_like(tmax, -1, dtype=torch.int32)
        for dom in self._round_lists(order):
            dom_ray = dom.repeat_interleave(self.packet)
            win = torch.where(dom_ray >= 0, best_t, 0.0)
            bucket = _round_buckets(win, dom, self.packet)
            t, code = traverse.nearest_slot(bucket, o, d, tmin, win, *pages)
            # a dead packet returns t 0, code -1: it never updates
            upd = (code >= 0) & (t < best_t)
            best_t = torch.where(upd, t, best_t)
            best_code = torch.where(
                upd, torch.clamp(dom_ray, min=0) * self.per_dom + code,
                best_code)
        return best_t, best_code

    def _rounds_anyhit(self, args):
        """Per-round any-hit: one `anyhit` launch per round on one-entry
        domain lists; occluded lanes and packets whose round is dead get an
        empty window."""
        order, o, d, tmin, tmax, *pages = args
        occ = torch.zeros_like(tmax, dtype=torch.int32)
        for dom in self._round_lists(order):
            live = (dom.repeat_interleave(self.packet) >= 0) & (occ == 0)
            win = torch.where(live, tmax, 0.0)
            bucket = _round_buckets(win, dom, self.packet)
            hit = traverse.anyhit(bucket[:, None].contiguous(), o, d, tmin,
                                  win, *pages)
            occ = occ | torch.where(
                bucket.repeat_interleave(self.packet) >= 0, hit, 0)
        return occ

    def _routed_anyhit_fused(self, args):
        """Fused any-hit: one `anyhit` launch over every packet's whole
        domain list, the occlusion carried per ray inside the kernel; 0
        where a packet was never live."""
        order, _, _, _, tmax, *_ = args
        pkt_live = (tmax.view(-1, self.packet) > 0).any(dim=1)
        ever = pkt_live & (order >= 0).any(dim=1)
        occ = traverse.anyhit(*args)
        return torch.where(ever.repeat_interleave(self.packet), occ, 0)

    def intersect(self, o, d, tmin, tmax):
        with trace.span("spray.glue.route"):
            args, inv = self._args(o, d, tmin, tmax)
        with trace.span("spray.glue.launch"):
            if self.routed == "fused":
                t, code = traverse.nearest(*args)
            else:
                t, code = self._rounds_nearest(args)
        with trace.span("spray.glue.hits"):
            return self._hits(o, d, tmax, args, inv, t, code)

    def occluded(self, o, d, tmax):
        with trace.span("spray.glue.route"):
            args, inv = self._args(o, d, torch.zeros_like(tmax), tmax)
        with trace.span("spray.glue.launch"):
            if self.routed == "fused":
                occ = self._routed_anyhit_fused(args)
            else:
                occ = self._rounds_anyhit(args)
        with trace.span("spray.glue.hits"):
            return occ[: o.shape[0]][inv] != 0
