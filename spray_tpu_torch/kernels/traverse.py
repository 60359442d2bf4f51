"""Cluster-BVH traversal: the wrappers of the three CUDA traversal kernels,
their plain PyTorch versions, the hit-attribute recompute and the
single-domain `ClusterBVHIntersector`.  (The port's other four kernels, the
brute and the binned-visit ones, live in `brute.py` and `binned.py`.)

Counterpart of ``spray_tpu/kernels/traverse.py``.  The TPU kernels
(`_nearest_fused_kernel`, `_anyhit_fused_kernel`, `_anyhit_kernel`,
`_nearest_kernel`) walk a packet of rays on lanes through a shared stack.
The port's CUDA kernels (``csrc/traverse.cu``) walk ray by ray, every ray in
the same front-to-back order: `nearest_kernel`, `nearest_slot_kernel` and
`anyhit_kernel` (bound by the FP32 operations of the ray-triangle tests on
the H100) give each live ray one WARP, whose lanes spread over a node's 8
children and a leaf's C triangles, with the stack in shared memory and a
block-level queue of live rays, so no lane waits on another ray's path; the
two nearest kernels share one body, the slot kernel walking a one-entry
list.  `walk_reference` follows the BVH the same way on the host and is what
every kernel is held against, counts included.  All keep the same result
contract:

  - nearest: the min over a cluster's rows of the packed key
        key = (bits(max(t, 0)) & ~127) | row        (INF_KEY on miss)
    t rebuilt rounded UP to the 128-ulp quantum, a hit taken only where
    t_up < best_t, front to back over the packet's domain list; the code
    carried is global: dom * (Nc * C) + cid * C + row.
  - nearest_slot: the same against ONE domain per packet (a bucket map);
    the code is domain-local, cid * C + row, and a dead packet (bucket -1)
    returns t 0, code -1.
  - any-hit: any t in (tmin, tmax) over the packet's domain list.  With
    the full (P, R) list it is the TPU's fused any-hit
    (`_anyhit_fused_kernel`: all rounds in one launch, occlusion carried);
    with one-entry lists it is the TPU's per-round `_anyhit_kernel`, as
    the scheduler and the per-round routed modes launch it.

Each wrapper sends a CPU tensor to the plain version and launches the CUDA
kernel for a CUDA tensor (or raises); there is no fallback between them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..core import geom
from ..core.device import resolve_device
from ..core.types import Hits
from . import _build
from .cluster_bvh import build_cluster_bvh
from .common import pad_rays

INF_KEY = 0x7F800000  # +inf bit pattern: beats every finite key
PACKET = 256  # rays per packet: one CUDA block (SPRAY_BLOCK in traverse.cu)
# launches of each CUDA kernel by its wrapper (the plain versions never count)
launches = {"nearest_kernel": 0, "anyhit_kernel": 0, "nearest_slot_kernel": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def tree_depth(meta):
    """Largest number of internal levels on a root-to-leaf path over all
    domains of a (D, Nn, 8) meta page; the kernels' stack needs 7*depth+1."""
    meta = np.asarray(meta)
    depth = 0
    for m in meta:
        level, frontier = 0, np.array([0])
        while frontier.size:
            level += 1
            ch = m[frontier].reshape(-1)
            frontier = ch[ch >= 0]
        depth = max(depth, level)
    return depth


# ---------------------------------------------------------------- plain ----

def _dense_keys(o, d, tmin, hi, w_dom, c0, c1, occl):
    """Keys (n, k*C) of rays against clusters [c0, c1) of one domain, or the
    occlusion mask (n,) when occl.  Same arithmetic as the CUDA kernels, one
    rounding per op."""
    wb = w_dom[c0:c1]  # (k, 4, 3C)
    c = wb.shape[2] // 3
    ox, oy, oz = (o[:, j, None, None] for j in range(3))
    dx, dy, dz = (d[:, j, None, None] for j in range(3))
    w0, w1, w2, w3 = (wb[None, :, j] for j in range(4))  # (1, k, 3C)
    op = ox * w0 + oy * w1 + oz * w2 + w3  # (n, k, 3C)
    dp = dx * w0 + dy * w1 + dz * w2
    ou, ov, ow = op[..., 0:c], op[..., c : 2 * c], op[..., 2 * c :]
    du, dv, dw = dp[..., 0:c], dp[..., c : 2 * c], dp[..., 2 * c :]
    dw_ok = torch.abs(dw) > 1e-20
    t = -ow / torch.where(dw_ok, dw, torch.ones_like(dw))
    u = ou + t * du
    v = ov + t * dv
    lo = tmin[:, None, None]
    hi = hi[:, None, None]
    tgate = ((t > lo) if occl else (t >= lo)) & (t < hi)
    ok = dw_ok & tgate & (u >= 0) & (v >= 0) & (u + v <= 1)
    if occl:
        return ok.flatten(1).any(dim=1)
    # -0.0 would bit-cast to INT_MIN and hide every real hit
    tc = torch.where(t > 0, t, torch.zeros_like(t))
    row = torch.arange(c, device=o.device, dtype=torch.int32)
    key = (tc.view(torch.int32) & -128) | row
    key = torch.where(ok, key, torch.full_like(key, INF_KEY))
    return key.flatten(1)


def _chunks(n_rays, nc, c, budget=1 << 24):
    """(ray chunk, cluster chunk) sizes keeping (rays, clusters, 3C) tensors
    near `budget` elements."""
    rays = min(n_rays, 4096)
    clusters = max(1, min(nc, budget // max(1, rays * 3 * c)))
    return rays, clusters


def _round_groups(order, r, packet, live):
    """Ray index sets of round r, grouped by domain: [(dom, idx), ...]."""
    dom_p = order[:, r]
    dom_ray = dom_p.repeat_interleave(packet)
    groups = []
    for dom in torch.unique(dom_p[dom_p >= 0]).tolist():
        idx = torch.nonzero((dom_ray == dom) & live).reshape(-1)
        if idx.numel():
            groups.append((dom, idx))
    return groups


def nearest_reference(order, o, d, tmin, tmax, bounds, meta, w, packet):
    """Plain PyTorch version of `nearest_kernel`: tests every cluster of
    every domain in each packet's list, densely (ignoring the BVH), with the
    kernel's key arithmetic and front-to-back ``t_up < best_t`` combine.
    Returns (t, code) of shape (N,)."""
    del bounds, meta  # the dense version specifies the result without a BVH
    _, nc, _, c3 = w.shape
    c = c3 // 3
    best_t = tmax.clone()
    best_code = torch.full_like(tmax, -1, dtype=torch.int32)
    live = tmax > 0
    for r in range(order.shape[1]):
        for dom, idx in _round_groups(order, r, packet, live):
            nr, nk = _chunks(idx.numel(), nc, c)
            for r0 in range(0, idx.numel(), nr):
                ii = idx[r0 : r0 + nr]
                oo, dd, lo, hi = o[ii], d[ii], tmin[ii], best_t[ii]
                kbest = torch.full_like(ii, INF_KEY, dtype=torch.int32)
                cbest = torch.zeros_like(ii, dtype=torch.int32)
                for c0 in range(0, nc, nk):
                    key = _dense_keys(oo, dd, lo, hi, w[dom], c0, c0 + nk, False)
                    kmin, arg = key.min(dim=1)  # first minimum: lowest cluster
                    better = kmin < kbest
                    kbest = torch.where(better, kmin, kbest)
                    cbest = torch.where(better, (c0 + arg // c).to(torch.int32), cbest)
                t_up = ((kbest & -128) + 128).view(torch.float32)
                improved = (kbest != INF_KEY) & (t_up < hi)
                code = (dom * nc + cbest) * c + (kbest & 127)
                best_t[ii] = torch.where(improved, t_up, hi)
                best_code[ii] = torch.where(improved, code, best_code[ii])
    return best_t, best_code


def anyhit_reference(order, o, d, tmin, tmax, bounds, meta, w, packet):
    """Plain PyTorch version of `anyhit_kernel`: any hit with t in
    (tmin, tmax) against every cluster of every listed domain.  Returns
    occ (N,) int32."""
    del bounds, meta
    _, nc, _, c3 = w.shape
    c = c3 // 3
    occ = torch.zeros_like(tmax, dtype=torch.int32)
    live = tmax > 0
    for r in range(order.shape[1]):
        for dom, idx in _round_groups(order, r, packet, live & (occ == 0)):
            nr, nk = _chunks(idx.numel(), nc, c)
            for r0 in range(0, idx.numel(), nr):
                ii = idx[r0 : r0 + nr]
                hit = torch.zeros_like(ii, dtype=torch.bool)
                for c0 in range(0, nc, nk):
                    hit |= _dense_keys(o[ii], d[ii], tmin[ii], tmax[ii],
                                       w[dom], c0, c0 + nk, True)
                occ[ii] = occ[ii] | hit.to(torch.int32)
    return occ


def nearest_slot_reference(bucket, o, d, tmin, tmax, bounds, meta, w, packet):
    """Plain PyTorch version of `nearest_slot_kernel`: `nearest_reference`
    over a one-entry domain list per packet, with the slot contract on top
    (domain-local code; dead packet -> t 0, code -1)."""
    t, code = nearest_reference(bucket[:, None], o, d, tmin, tmax, bounds,
                                meta, w, packet)
    dom = bucket.repeat_interleave(packet)
    dead = dom < 0
    per_dom = w.shape[1] * (w.shape[3] // 3)
    code = torch.where(code >= 0, code - dom * per_dom, code)
    return (torch.where(dead, torch.zeros_like(t), t),
            torch.where(dead, torch.full_like(code, -1), code))


def child_ranks(te, hit):
    """Rank of each of a node's 8 children among its HIT children by
    (entry distance, slot index), -1 for a missed child: the count the
    warp-per-ray kernels take with 8 shuffles.  It is the order of a stable
    insertion sort by entry distance; the child of rank q is pushed at stack
    offset k - 1 - q of k hit children, the nearest on top."""
    slot = np.arange(te.shape[0])
    before = (te[None, :] < te[:, None]) | (
        (te[None, :] == te[:, None]) & (slot[None, :] < slot[:, None]))
    return np.where(hit, (before & hit[None, :]).sum(axis=1), -1)


def walk_reference(order, o, d, tmin, tmax, bounds, meta, w, packet,
                   occl=False, stack=128):
    """BVH-following plain version of `nearest_kernel` (occl False) and
    `anyhit_kernel` (occl True), and of `nearest_slot_kernel` on one-entry
    lists (`order` = bucket[:, None], codes less the domain offset, dead
    packets t 0): a host loop per ray that walks each listed
    domain's tree exactly as the CUDA kernels do -- an ordered stack of
    (child, entry t) culled at pop time, a node's hit children pushed by
    `child_ranks`, a leaf's C rows tested with `_dense_keys`' arithmetic and
    reduced to their min key (the kernels' min over lanes and strides) -- so
    it gives
    their t, code (ties included), occlusion AND counts.  For tests and the
    chip smoke run only; takes tensors on any device, returns CPU tensors:
    (t, code, counts), or (occ, counts) when occl, with counts a dict of
    node visits, leaf visits, ray-triangle tests and the stack's high-water
    mark over all rays."""
    order, o, d, tmin, tmax, bounds, meta, w = (
        x.detach().cpu() for x in (order, o, d, tmin, tmax, bounds, meta, w))
    order_n, o_n, d_n, tmin_n, tmax_n, bounds_n, meta_n = (
        x.numpy() for x in (order, o, d, tmin, tmax, bounds, meta))
    nc, c = w.shape[1], w.shape[3] // 3
    f32, inf = np.float32, np.float32(np.inf)
    t_out = tmax_n.copy()
    code_out = np.full(t_out.shape, -1, np.int32)
    occ_out = np.zeros(t_out.shape, np.int32)
    counts = {"nodes": 0, "leaves": 0, "tests": 0, "stack_high": 0}
    stk_m = np.zeros(stack, np.int32)
    stk_t = np.zeros(stack, np.float32)
    with np.errstate(all="ignore"):
        for i in np.nonzero(tmax_n > 0)[0]:  # a dead lane keeps tmax, -1, 0
            oi, di, lo = o_n[i], d_n[i], tmin_n[i]
            inv = f32(1) / np.where(np.abs(di) > f32(1e-12), di, f32(1e-12))
            ray = (o[i:i + 1], d[i:i + 1], tmin[i:i + 1])
            best_t, best_code, occluded = tmax_n[i], -1, False
            for dom in order_n[i // packet].tolist():
                if dom < 0 or occluded:
                    break
                stk_m[0], stk_t[0], sp = 0, lo, 1
                while sp > 0:
                    sp -= 1
                    m = int(stk_m[sp])
                    if stk_t[sp] > best_t:
                        continue  # culled by a nearer hit since
                    if m >= 0:
                        counts["nodes"] += 1
                        b = bounds_n[dom, m]
                        t0 = (b[:, 0:3] - oi) * inv
                        t1 = (b[:, 3:6] - oi) * inv
                        near, far = np.fmin(t0, t1), np.fmax(t0, t1)
                        tn = np.fmax(np.fmax(near[:, 0], near[:, 1]),
                                     np.fmax(near[:, 2], lo))
                        tf = np.fmin(np.fmin(far[:, 0], far[:, 1]),
                                     np.fmin(far[:, 2], best_t))
                        te = np.where(tn <= tf, tn, inf)
                        hit = (meta_n[dom, m] != -1) & (te < inf)
                        k = int(hit.sum())
                        if sp + k > stack:
                            raise ValueError(f"stack of {stack} overflows")
                        pos = sp + k - 1 - child_ranks(te, hit)[hit]
                        stk_m[pos] = meta_n[dom, m][hit]
                        stk_t[pos] = te[hit]
                        sp += k
                        counts["stack_high"] = max(counts["stack_high"], sp)
                        continue
                    counts["leaves"] += 1
                    counts["tests"] += c
                    cid = -(m + 2)
                    hi = torch.tensor([best_t], dtype=torch.float32)
                    res = _dense_keys(*ray, hi, w[dom], cid, cid + 1, occl)
                    if occl:
                        occluded = bool(res[0])
                        if occluded:
                            break
                        continue
                    kmin = int(res[0].min())
                    if kmin == INF_KEY:
                        continue
                    t_up = np.array((kmin & -128) + 128, np.int32).view(f32)
                    if t_up < best_t:
                        best_t = t_up[()]
                        best_code = (dom * nc + cid) * c + (kmin & 127)
            t_out[i], code_out[i], occ_out[i] = best_t, best_code, occluded
    if occl:
        return torch.from_numpy(occ_out), counts
    return torch.from_numpy(t_out), torch.from_numpy(code_out), counts


# -------------------------------------------------------------- wrappers ----

def live_buckets(win_pk):
    """(P, packet) windows -> (P,) i32 bucket map: page 0, or -1 for a packet
    no lane of which has a live window.  The single source of the
    dead-packet sentinel."""
    return torch.where((win_pk > 0).any(dim=1), 0, -1).to(torch.int32)


def _check(order, o, d, tmin, tmax, bounds, meta, w, packet):
    """Inputs of every wrapper; `order` is a (P, R) domain list, or the
    (P,) bucket map of `nearest_slot`."""
    dev = o.device
    sel = ("bucket", 1) if order.dim() == 1 else ("order", 2)
    want = [
        (sel[0], order, torch.int32, sel[1]), ("o", o, torch.float32, 2),
        ("d", d, torch.float32, 2), ("tmin", tmin, torch.float32, 1),
        ("tmax", tmax, torch.float32, 1), ("bounds", bounds, torch.float32, 4),
        ("meta", meta, torch.int32, 3), ("w", w, torch.float32, 4),
    ]
    _build.check_tensors(dev, want)
    n = o.shape[0]
    n_dom, nn = bounds.shape[0], bounds.shape[1]
    if (o.shape[1] != 3 or d.shape != o.shape or tmin.shape != (n,)
            or tmax.shape != (n,)):
        raise ValueError("rays: want o, d (N, 3) and tmin, tmax (N,)")
    if n != order.shape[0] * packet:
        raise ValueError(f"N={n} rays != {order.shape[0]} packets x {packet}")
    if bounds.shape[2:] != (8, 6) or meta.shape != (n_dom, nn, 8):
        raise ValueError("bounds (D, Nn, 8, 6) / meta (D, Nn, 8) mismatch")
    if w.shape[0] != n_dom or w.shape[2] != 4 or w.shape[3] % 3:
        raise ValueError("w: want (D, Nc, 4, 3C)")
    if w.shape[3] // 3 > 128:
        raise ValueError("cluster size C must be <= 128 (7-bit row key)")
    if order.dim() == 2 and order.shape[1] > n_dom:
        raise ValueError("order has more rounds than domains")


def _launch(fn, order, o, d, tmin, tmax, bounds, meta, w, packet, depth,
            outs, counters):
    if counters is None:  # while a profiler records, the trace's buffer
        counters = trace.kernel_counters(o.device)
    stack = _build.load("traverse").spray_stack_size()
    if 7 * depth + 1 > stack:
        raise ValueError(f"BVH depth {depth} needs a stack of {7 * depth + 1}"
                         f" entries; the kernel has {stack}")
    if counters is not None and (counters.dtype != torch.int64
                                 or counters.shape != (3,)
                                 or counters.device != o.device):
        raise ValueError("counters: want a (3,) int64 tensor on the card")
    n = o.shape[0]
    nn, nc, c = bounds.shape[1], w.shape[1], w.shape[3] // 3
    # a domain list passes its rounds, a bucket map the number of pages
    width = order.shape[1] if order.dim() == 2 else bounds.shape[0]
    _build.launch(
        "traverse", fn, o.device, order.data_ptr(), width, packet,
        o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
        bounds.data_ptr(), meta.data_ptr(), w.data_ptr(), nn, nc, c,
        *[x.data_ptr() for x in outs],
        None if counters is None else counters.data_ptr(),
    )


def nearest(order, o, d, tmin, tmax, bounds, meta, w, packet, depth,
            counters=None):
    """Nearest hit of every ray over its packet's domain list.

    order (P, R) i32 front-to-back domain ids per packet (-1 ends a list);
    o, d (N, 3), tmin, tmax (N,) f32 with N = P * packet; pages bounds
    (D, Nn, 8, 6) f32, meta (D, Nn, 8) i32, w (D, Nc, 4, 3C) f32; depth:
    tree depth of the pages (`tree_depth`).  counters: optional (3,) int64
    CUDA tensor that receives (node visits, leaf visits, ray-tri tests);
    while a profiler records, the kernels add into
    `trace.kernel_counters` when none is given.
    Returns (t (N,) f32 rounded-up hit distance or tmax, code (N,) i32
    global code or -1)."""
    _check(order, o, d, tmin, tmax, bounds, meta, w, packet)
    if o.device.type == "cpu":
        return nearest_reference(order, o, d, tmin, tmax, bounds, meta, w, packet)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    t = torch.empty_like(tmax)
    code = torch.empty(tmax.shape, dtype=torch.int32, device=o.device)
    if o.shape[0]:
        _launch("spray_nearest", order, o, d, tmin, tmax, bounds, meta, w,
                packet, depth, (t, code), counters)
        launches["nearest_kernel"] += 1
    return t, code


def nearest_slot(bucket, o, d, tmin, tmax, bounds, meta, w, packet, depth,
                 counters=None):
    """Nearest hit of every ray against ONE domain per packet.

    bucket (P,) i32: each packet's page index into bounds / meta / w, -1 for
    a dead packet (`live_buckets`); other arguments as `nearest`.  Returns
    (t (N,) f32 rounded-up hit distance or tmax, code (N,) i32 domain-local
    code cluster * C + row or -1); a dead packet's lanes get t 0, code -1."""
    _check(bucket, o, d, tmin, tmax, bounds, meta, w, packet)
    if o.device.type == "cpu":
        return nearest_slot_reference(bucket, o, d, tmin, tmax, bounds, meta,
                                      w, packet)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    t = torch.empty_like(tmax)
    code = torch.empty(tmax.shape, dtype=torch.int32, device=o.device)
    if o.shape[0]:
        _launch("spray_nearest_slot", bucket, o, d, tmin, tmax, bounds, meta,
                w, packet, depth, (t, code), counters)
        launches["nearest_slot_kernel"] += 1
    return t, code


def anyhit(order, o, d, tmin, tmax, bounds, meta, w, packet, depth,
           counters=None):
    """Occlusion of every ray in (tmin, tmax) over its packet's domain list.
    Same arguments as `nearest`; returns occ (N,) i32 (1 = occluded)."""
    _check(order, o, d, tmin, tmax, bounds, meta, w, packet)
    if o.device.type == "cpu":
        return anyhit_reference(order, o, d, tmin, tmax, bounds, meta, w, packet)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    occ = torch.empty(tmax.shape, dtype=torch.int32, device=o.device)
    if o.shape[0]:
        _launch("spray_anyhit", order, o, d, tmin, tmax, bounds, meta, w,
                packet, depth, (occ,), counters)
        launches["anyhit_kernel"] += 1
    return occ


# ------------------------------------------------------------ attributes ----

def tri_soa_from_scene(scene, device):
    """(v0, e1, e2) tensors in ORIGINAL face order, for the hit-attribute
    recompute against the committed triangle."""
    verts = np.asarray(scene.vertices, np.float32)
    faces = np.asarray(scene.faces, np.int64)
    tv = verts[faces.reshape(-1)].reshape(-1, 3, 3)
    return tuple(
        torch.as_tensor(np.ascontiguousarray(x), device=device)
        for x in (tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    )


def attrs_for_prims(v0, e1, e2, prim, o, d, t_kernel, tmax):
    """Recompute (t, u, v, valid) for committed prim ids with the brute
    oracle's Möller–Trumbore; t falls back to the kernel's value where the
    recompute disagrees on validity (grazing hits at f32 precision)."""
    safe = torch.clamp(prim, min=0).long()
    t, u, v, ok = geom.moller_trumbore(o, d, v0[safe], e1[safe], e2[safe])
    valid = prim >= 0
    t = torch.where(valid & ok, t, torch.where(valid, t_kernel, tmax))
    zero = torch.zeros_like(u)
    return t, torch.where(valid, u, zero), torch.where(valid, v, zero), valid


class ClusterBVHIntersector:
    """Drop-in intersector over ONE cluster BVH: `nearest_slot` for
    intersect, `anyhit` with a one-entry domain list for occluded
    (counterpart of ``spray_tpu.kernels.traverse.ClusterBVHIntersector``,
    on the compact f32 pages)."""

    def __init__(self, scene, cbvh=None, device=None):
        device = resolve_device(device)
        if cbvh is None:
            cbvh = build_cluster_bvh(np.asarray(scene.vertices),
                                     np.asarray(scene.faces))

        def dev(x, dtype):
            return torch.as_tensor(np.ascontiguousarray(x, dtype),
                                   device=device)[None]

        self.device = device
        self.bounds = dev(cbvh.bounds, np.float32)
        self.meta = dev(cbvh.meta, np.int32)
        self.w = dev(cbvh.w, np.float32)
        self.tri_ids = dev(np.asarray(cbvh.tri_ids).reshape(-1), np.int64)[0]
        self.depth = tree_depth(np.asarray(cbvh.meta)[None])
        self.v0, self.e1, self.e2 = tri_soa_from_scene(scene, device)

    def _args(self, o, d, tmin, tmax):
        rays = pad_rays(o, d, tmin, tmax, PACKET)
        bucket = live_buckets(rays[3].view(-1, PACKET))
        return (bucket, *rays, self.bounds, self.meta, self.w, PACKET,
                self.depth)

    def intersect(self, o, d, tmin, tmax):
        n = o.shape[0]
        t, code = nearest_slot(*self._args(o, d, tmin, tmax))
        t, code = t[:n], code[:n]
        prim = torch.where(code >= 0, self.tri_ids[torch.clamp(code, min=0)],
                           -1).to(torch.int32)
        t, u, v, valid = attrs_for_prims(self.v0, self.e1, self.e2, prim, o,
                                         d, t, tmax)
        return Hits(t=torch.where(valid, t, tmax), prim=prim, u=u, v=v,
                    valid=valid)

    def occluded(self, o, d, tmax):
        bucket, *rest = self._args(o, d, torch.zeros_like(tmax), tmax)
        return anyhit(bucket[:, None].contiguous(), *rest)[: o.shape[0]] != 0
