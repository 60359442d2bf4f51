"""Binned cull+visit tracer: supernode culling in PyTorch, triangle visits
in two hand-written CUDA kernels.

Counterpart of ``spray_tpu/kernels/binned.py``.  The scene's Morton-ordered
clusters of 128 triangles are grouped by 8 into supernodes with known
AABBs.  A wavefront is cut into packets of BP = 128 rays; per packet a
conservative frustum-vs-AABB cull gives each supernode an entry lower bound
(`supernode_entries`), the supernodes are sorted front to back, and bands of
K of them are visited per chase round until no unprocessed supernode's entry
can beat any live ray's best t (the commit invariant).  A visit list is flat:
(packet, supernode, 8-bit cluster mask, first, last); the visit kernels
(``csrc/binned.cu``) run Möller–Trumbore of a packet's 128 rays against each
masked cluster, with the formula of `core/geom.moller_trumbore`, and
accumulate the best (t, code) or the occlusion over a packet's run of
visits.  Both kernels split a run over blocks of a few visits each: the
nearest kernel merges their bests per ray with a 64-bit key
(`nearest_visits_split_reference` is its host model), the any-hit kernel
ORs their flags in place (`anyhit_visits_split_reference`).

Where the reference loops on the device (``lax.while_loop``), the port loops
on the host: each chase round reads one flag from the card.  `stats` counts
those reads.

Each kernel wrapper sends a CPU tensor to the plain version and launches the
CUDA kernel for a CUDA tensor (or raises); there is no fallback between
them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import geom
from ..core.device import resolve_device
from ..core.types import Hits
from . import _build
from .cluster_bvh import CLUSTER, build_clusters
from .common import pad_rays
from .traverse import attrs_for_prims, tri_soa_from_scene

BP = 128  # rays per visit packet (one CUDA block, BINNED_BP in binned.cu)
GROUP = 8  # clusters per supernode
INF = float("inf")
# launches of each CUDA kernel by its wrapper (the plain versions never count)
launches = {"binned_nearest_kernel": 0, "binned_anyhit_kernel": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def new_stats():
    """Host-side counts of the trace loops: intersect/occluded calls, chase
    rounds or chunks (one visit-kernel launch each), visit-list entries
    launched (null visits included) and host reads of a device value."""
    return {"calls": 0, "rounds": 0, "visits": 0, "syncs": 0}


# ---------------------------------------------------------------------------
# Host build
# ---------------------------------------------------------------------------


class BinnedScene:
    """Cluster pool grouped into supernodes (host numpy arrays).

    tri9   (S+1, 9, GROUP*C) f32 : per-supernode triangle SoA rows
                                   [v0x v0y v0z e1x e1y e1z e2x e2y e2z],
                                   cluster-major columns.  Row S is the null
                                   supernode (degenerate tris, never hit).
    cbox   (S+1, GROUP, 6)   f32 : per-cluster AABBs (slab layout); padded
                                   clusters and the null supernode carry
                                   (+inf, -inf) boxes.
    sbox   (S, 6)            f32 : supernode AABBs (for the cull).
    tri_ids ((S+1)*GROUP*C,) i32 : global tri ids, -1 padding.
    world_lo, world_hi (3,)  f32 : hull of the finite cluster boxes.
    """

    FIELDS = ("tri9", "cbox", "sbox", "tri_ids", "world_lo", "world_hi")

    def __init__(self, vertices, faces):
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        _, ids, clo, chi = build_clusters(vertices, faces)
        nc = ids.shape[0]
        s = -(-nc // GROUP)
        ncp = s * GROUP
        c = CLUSTER

        def pad(a, fill):
            if a.shape[0] == ncp:
                return a
            return np.concatenate(
                [a, np.full((ncp - a.shape[0],) + a.shape[1:], fill, a.dtype)]
            )

        ids = pad(ids, -1)
        clo = pad(clo, np.inf)
        chi = pad(chi, -np.inf)

        # triangle SoA in cluster order (padding tris: v0=e1=e2=0 -> det==0)
        flat = ids.reshape(-1)
        ok = flat >= 0
        safe = np.where(ok, flat, 0)
        tv = vertices[faces[safe].reshape(-1)].reshape(-1, 3, 3)
        v0 = np.where(ok[:, None], tv[:, 0], 0.0)
        e1 = np.where(ok[:, None], tv[:, 1] - tv[:, 0], 0.0)
        e2 = np.where(ok[:, None], tv[:, 2] - tv[:, 0], 0.0)
        soa = np.concatenate([v0, e1, e2], axis=1).astype(np.float32)  # (T,9)
        tri9 = soa.reshape(s, GROUP * c, 9).transpose(0, 2, 1)  # (S,9,G*C)
        tri9 = np.concatenate(
            [tri9, np.zeros((1,) + tri9.shape[1:], np.float32)]
        )

        cbox = np.concatenate([clo, chi], axis=1).reshape(s, GROUP, 6)
        null_box = np.zeros((1, GROUP, 6), np.float32)
        null_box[:, :, 0:3] = np.inf
        null_box[:, :, 3:6] = -np.inf

        slo = clo.reshape(s, GROUP, 3).min(1)
        shi = chi.reshape(s, GROUP, 3).max(1)
        finite = np.isfinite(clo[:, 0])
        ids_p = np.concatenate([ids, np.full((GROUP, c), -1, np.int32)])
        self.num_supernodes = s
        self.tri9 = np.ascontiguousarray(tri9)
        self.cbox = np.concatenate([cbox, null_box]).astype(np.float32)
        self.sbox = np.concatenate([slo, shi], axis=1).astype(np.float32)
        self.world_lo = clo[finite].min(0)
        self.world_hi = chi[finite].max(0)
        self.tri_ids = ids_p.reshape(-1).astype(np.int32)

    def arrays(self):
        """The six arrays by name, as `BinnedIntersector.from_arrays` takes
        them."""
        return {k: getattr(self, k) for k in self.FIELDS}


# ---------------------------------------------------------------------------
# Cull phase (PyTorch): conservative packet frustum vs supernode AABBs
# ---------------------------------------------------------------------------


def packet_intervals(o, d, tmin, tmax):
    """Per-packet conservative ray bounds over LIVE rays.

    o, d (P*BP, 3), tmin, tmax (P*BP,).  A ray is live iff its window is
    non-empty (tmax > tmin); dead and padding rays are left out of the hull
    so retired rays never widen the frustum.  The 3e38 sentinel is finite
    on purpose: an all-dead packet's bounds must not turn into inf - inf.
    Returns dict of (P, 3) olo/ohi/dlo/dhi, (P,) tlo and (P,) any_live.
    """
    p = o.shape[0] // BP
    o3, d3 = o.view(p, BP, 3), d.view(p, BP, 3)
    tmin_p, tmax_p = tmin.view(p, BP), tmax.view(p, BP)
    live = tmax_p > tmin_p  # (P, BP)
    live3 = live[:, :, None]
    big = 3e38
    return {
        "olo": torch.where(live3, o3, big).amin(dim=1),
        "ohi": torch.where(live3, o3, -big).amax(dim=1),
        "dlo": torch.where(live3, d3, big).amin(dim=1),
        "dhi": torch.where(live3, d3, -big).amax(dim=1),
        "tlo": torch.where(live, tmin_p, big).amin(dim=1),
        "any_live": live.any(dim=1),
    }


def _axis_interval(blo, bhi, olo, ohi, dlo, dhi):
    """Conservative per-axis [entry_lb, exit_ub] of box slab vs ray bundle.

    blo/bhi: (1, S) or (P, S) box planes; o/d bounds: (P, 1).  Returns a
    (P, S) pair.  Mixed-sign direction intervals contribute (-inf, +inf)
    (no constraint): the cull may only ever overestimate overlap.  Boxes of
    padded clusters are (+inf, -inf); `torch.minimum` / `maximum` propagate
    the NaN of inf * 0 as XLA's do, and every compare with NaN is false.
    """
    pos = dlo > 0
    neg = dhi < 0
    # positive branch
    rlo_p = 1.0 / torch.where(pos, dlo, 1.0)
    rhi_p = 1.0 / torch.where(pos, dhi, 1.0)
    nlo_p = blo - ohi  # (P, S)
    nhi_p = bhi - olo
    ent_p = torch.minimum(nlo_p * rlo_p, nlo_p * rhi_p)
    ext_p = torch.maximum(nhi_p * rlo_p, nhi_p * rhi_p)
    # negative branch (march from the bhi side with |d|)
    rlo_n = 1.0 / torch.where(neg, -dhi, 1.0)
    rhi_n = 1.0 / torch.where(neg, -dlo, 1.0)
    nlo_n = olo - bhi
    nhi_n = ohi - blo
    ent_n = torch.minimum(nlo_n * rlo_n, nlo_n * rhi_n)
    ext_n = torch.maximum(nhi_n * rlo_n, nhi_n * rhi_n)
    ent = torch.where(pos, ent_p, torch.where(neg, ent_n, -INF))
    ext = torch.where(pos, ext_p, torch.where(neg, ext_n, INF))
    return ent, ext


def _box_entry_exit(ivals, lo, hi):
    """(entry, exit) of the packet frustums against boxes whose planes are
    lo[a], hi[a] per axis a, each (1, S) or (P, S)."""
    ents, exts = [], []
    for a in range(3):
        ent, ext = _axis_interval(
            lo[a], hi[a],
            ivals["olo"][:, a:a + 1], ivals["ohi"][:, a:a + 1],
            ivals["dlo"][:, a:a + 1], ivals["dhi"][:, a:a + 1],
        )
        ents.append(ent)
        exts.append(ext)
    entry = torch.maximum(
        torch.maximum(ents[0], ents[1]),
        torch.maximum(ents[2], ivals["tlo"][:, None]),
    )
    exit_ = torch.minimum(torch.minimum(exts[0], exts[1]), exts[2])
    return entry, exit_


def supernode_entries(ivals, sbox):
    """Conservative (P, S) entry lower bounds; +inf where provably disjoint.

    Any ray in the packet that could intersect the supernode within its
    window yields entry <= that ray's true entry t (conservative ordering).
    """
    entry, exit_ = _box_entry_exit(
        ivals, [sbox[None, :, a] for a in range(3)],
        [sbox[None, :, 3 + a] for a in range(3)])
    hit = (entry <= exit_) & ivals["any_live"][:, None]
    return torch.where(hit, entry, INF)


def cluster_masks(ivals, cbox, sn, upper):
    """Conservative per-visit cluster bitmasks.  sn (P, K) selected
    supernodes, upper (P,); returns (P, K) int32 bitmasks (bit g = the
    packet frustum overlaps cluster g below `upper`)."""
    p, k = sn.shape
    boxes = cbox[sn.long()]  # (P, K, GROUP, 6)
    entry, exit_ = _box_entry_exit(
        ivals, [boxes[..., a].reshape(p, -1) for a in range(3)],
        [boxes[..., 3 + a].reshape(p, -1) for a in range(3)])
    hit = (entry <= exit_) & (entry < upper[:, None])
    hit = hit & ivals["any_live"][:, None]
    bits = hit.view(p, k, GROUP).to(torch.int32)
    weights = 1 << torch.arange(GROUP, dtype=torch.int32, device=sn.device)
    return (bits * weights).sum(dim=-1, dtype=torch.int32)  # (P, K)


# ---------------------------------------------------------------------------
# Visit kernels: wrappers and plain versions
# ---------------------------------------------------------------------------


def _run_ranks(first, last, cmask):
    """(V,) rank of each visit inside its run, or -1 for a visit outside
    any run or with a zero mask."""
    idx = torch.arange(first.shape[0], device=first.device)
    is_first, is_last = first != 0, last != 0
    start = torch.where(is_first, idx, 0).cummax(dim=0).values
    # inside a run: more firsts up to here than lasts before here
    opened = is_first.cumsum(0) - (is_last.cumsum(0) - is_last.long())
    return torch.where((opened > 0) & (cmask != 0), idx - start, -1)


def _run_steps(first, last, cmask):
    """Visits grouped by their rank inside their run: a list, in rank
    order, of the indices of the visits of that rank that lie inside a run
    and have a nonzero mask.  Visits of one rank belong to different runs
    (so to different packets) and can be processed together."""
    nv = first.shape[0]
    rank = _run_ranks(first, last, cmask)
    steps = []
    for j in range(int(rank.max()) + 1 if nv else 0):
        sel = torch.nonzero(rank == j).view(-1)
        if sel.numel():
            steps.append(sel)
    return steps


def _cluster_t(tri9, sn, k, o, d, ray_idx):
    """t (m, C, BP) of m packets' rays (ray_idx (m, BP)) against cluster k
    of supernodes sn (m,): +inf where the test misses."""
    c = CLUSTER
    tri = tri9[sn.long()][:, :, k * c:(k + 1) * c]  # (m, 9, C)
    col = lambda a: tri[:, a:a + 3].permute(0, 2, 1)[:, :, None, :]  # noqa: E731
    t, _, _, _ = geom.moller_trumbore(
        o[ray_idx][:, None], d[ray_idx][:, None], col(0), col(3), col(6))
    return t


def _visit_chunks(steps, cmask, chunk):
    """(k, visit indices) in the kernels' order: ranks, then clusters."""
    for sel in steps:
        for k in range(GROUP):
            sub = sel[((cmask[sel] >> k) & 1) != 0]
            for s in range(0, sub.numel(), chunk):
                yield k, sub[s:s + chunk]


def nearest_visits_reference(pkt, sn, cmask, first, last, o, d, tmin, tri9,
                             best_t, best_code, chunk=64):
    """Plain PyTorch version of `binned_nearest_kernel`."""
    bt, bc = best_t.clone().view(-1, BP), best_code.clone().view(-1, BP)
    lane = torch.arange(BP, device=o.device)
    for k, vis in _visit_chunks(_run_steps(first, last, cmask), cmask, chunk):
        p, s = pkt[vis].long(), sn[vis]
        ray_idx = p[:, None] * BP + lane
        tm = _cluster_t(tri9, s, k, o, d, ray_idx)  # (m, C, BP)
        cur = bt[p]  # (m, BP)
        gate = (tm >= tmin[ray_idx][:, None]) & (tm < cur[:, None])
        tm = torch.where(gate, tm, INF)
        trow, jsel = tm.min(dim=1)  # first minimum: the lowest row
        improved = trow < cur
        code = ((s[:, None] * GROUP + k) * CLUSTER + jsel).to(torch.int32)
        bt[p] = torch.where(improved, trow, cur)
        bc[p] = torch.where(improved, code, bc[p])
    return bt.view(-1), bc.view(-1)


def _order_bits(t):
    """t (f32 numpy) as uint32 keys that order like t, -0.0 taken as +0.0
    (`order_bits` in binned.cu)."""
    u = np.where(t == 0, np.float32(0), t).astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | np.uint32(0x80000000))


def _span_segments(first, last, span):
    """The run segments `binned_nearest_kernel` walks, block by block: for
    each span [a, a + span) of the visit list, the (run's first visit,
    visits) of every run that the span reaches, a segment ending at the
    run's `last` flag, at the next `first` or at the span's end.  A visit
    between a `last` and the next `first` lies in no segment."""
    flagged = (first != 0) | (last != 0)
    segments = []
    for a in range(0, first.shape[0], span):
        run = -1
        if not first[a]:
            before = np.nonzero(flagged[:a])[0]  # open_run
            if before.size and not last[before[-1]]:
                run = int(before[-1])
        seg = []
        for v in range(a, min(a + span, first.shape[0])):
            if first[v]:
                if run >= 0:
                    segments.append((run, seg))
                run, seg = v, []
            if run < 0:
                continue
            seg.append(v)
            if last[v]:
                segments.append((run, seg))
                run, seg = -1, []
        if run >= 0:
            segments.append((run, seg))
    return segments


def nearest_visits_split_reference(pkt, sn, cmask, first, last, o, d, tmin,
                                   tri9, best_t, best_code, span):
    """Host model of `binned_nearest_kernel`'s split of runs over blocks:
    each span of `span` visits walks its run segments (`_span_segments`)
    serially from the run's INPUT best_t, each ray's segment best is merged
    by the 64-bit key (`_order_bits(t)`, visit << 10 | cluster << 7 | row)
    with a min, and the winner's t is recomputed from its (visit, cluster,
    row), so a -0.0 hit keeps its sign.  Equals `nearest_visits_reference`
    at every span.  Takes tensors on any device; returns updated CPU copies
    of (best_t, best_code)."""
    pkt, sn, cmask, first, last, o, d, tmin, tri9, best_t, best_code = (
        x.cpu() for x in (pkt, sn, cmask, first, last, o, d, tmin, tri9,
                          best_t, best_code))
    no_key = np.iinfo(np.uint64).max
    keys = np.full(best_t.shape[0], no_key, np.uint64)
    lane = torch.arange(BP)
    for run, seg in _span_segments(first.numpy(), last.numpy(), span):
        ray_idx = int(pkt[run]) * BP + lane
        win = best_t[ray_idx]
        cur, where = win.clone(), torch.zeros(BP, dtype=torch.int64)
        for v in seg:
            for k in range(GROUP):
                if not (int(cmask[v]) >> k) & 1:
                    continue
                tm = _cluster_t(tri9, sn[v:v + 1], k, o, d, ray_idx[None])[0]
                tm = torch.where((tm >= tmin[ray_idx]) & (tm < cur), tm, INF)
                trow, jsel = tm.min(dim=0)  # first minimum: the lowest row
                better = trow < cur
                cur = torch.where(better, trow, cur)
                where = torch.where(better, (v << 10) | (k << 7) | jsel, where)
        hit = (cur < win).numpy()
        key = ((_order_bits(cur.numpy()).astype(np.uint64) << np.uint64(32))
               | where.numpy().astype(np.uint64))
        np.minimum.at(keys, ray_idx.numpy()[hit], key[hit])
    bt, bc = best_t.clone(), best_code.clone()
    for i in np.nonzero(keys != no_key)[0].tolist():
        w = int(keys[i]) & 0xFFFFFFFF
        v, k, row = w >> 10, (w >> 7) & 7, w & 127
        bt[i] = _cluster_t(tri9, sn[v:v + 1], k, o, d, torch.tensor([[i]]))[0, row, 0]
        bc[i] = (int(sn[v]) * GROUP + k) * CLUSTER + row
    return bt, bc


def anyhit_visits_reference(pkt, sn, cmask, first, last, o, d, tmin, tmax,
                            tri9, occ, chunk=64):
    """Plain PyTorch version of `binned_anyhit_kernel`."""
    oc = occ.clone().view(-1, BP)
    lane = torch.arange(BP, device=o.device)
    for k, vis in _visit_chunks(_run_steps(first, last, cmask), cmask, chunk):
        p = pkt[vis].long()
        ray_idx = p[:, None] * BP + lane
        tm = _cluster_t(tri9, sn[vis], k, o, d, ray_idx)
        win = torch.where(oc[p] != 0, 0.0, tmax[ray_idx])
        hit = (tm > tmin[ray_idx][:, None]) & (tm < win[:, None])
        oc[p] = oc[p] | hit.any(dim=1).to(torch.int32)
    return oc.view(-1)


def anyhit_visits_split_reference(pkt, sn, cmask, first, last, o, d, tmin,
                                  tmax, tri9, occ, span):
    """Host model of `binned_anyhit_kernel`'s split of runs over blocks:
    each span of `span` visits walks its run segments (`_span_segments`)
    from the run's INPUT flags, and each segment's hits are ORed into the
    result.  (The kernel's blocks also read the flags other blocks have
    set; that only skips tests whose answer is already 1.)  Equals
    `anyhit_visits_reference` at every span.  Takes tensors on any device;
    returns an updated CPU copy of occ."""
    pkt, sn, cmask, first, last, o, d, tmin, tmax, tri9, occ = (
        x.cpu() for x in (pkt, sn, cmask, first, last, o, d, tmin, tmax,
                          tri9, occ))
    out = occ.clone()
    lane = torch.arange(BP)
    for run, seg in _span_segments(first.numpy(), last.numpy(), span):
        ray_idx = int(pkt[run]) * BP + lane
        hit = occ[ray_idx] != 0
        for v in seg:
            for k in range(GROUP):
                if not (int(cmask[v]) >> k) & 1:
                    continue
                tm = _cluster_t(tri9, sn[v:v + 1], k, o, d, ray_idx[None])[0]
                hit |= ((tm > tmin[ray_idx]) & (tm < tmax[ray_idx])).any(dim=0)
        out[ray_idx] |= hit.to(torch.int32)
    return out


def anyhit_serial_tests(pkt, sn, cmask, first, last, o, d, tmin, tmax, tri9,
                        occ):
    """Ray-triangle tests, per lane ((P*BP,) int64), that the serial order
    of a run needs: the bound of `binned_anyhit_kernel` counts these, not
    the tests the kernel did, which depend on the order its blocks ran in.
    A lane occluded at input, or whose window is empty (tmax <= tmin: it
    can never hit), needs none; any other lane tests every row of every
    gated cluster of its run, in (visit, cluster, row) order, up to and
    including its first hit (tmin < t < tmax).  Walks the runs one rank at
    a time, all clusters of a visit at once, 128 visits (2^24 tests) a
    step, leaving out packets whose lanes are all done."""
    dev = o.device
    tests = torch.zeros(o.shape[0], dtype=torch.int64, device=dev)
    if first.shape[0] == 0:
        return tests
    rank = _run_ranks(first, last, cmask)
    order = torch.argsort(rank, stable=True)
    sizes = torch.bincount(rank + 1).tolist()  # rank -1 first: no tests
    active = ((occ == 0) & (tmax > tmin)).view(-1, BP)
    lane = torch.arange(BP, device=dev)
    cols = torch.arange(GROUP * CLUSTER, device=dev) // CLUSTER
    step = 128  # visits a step: 128 x 1024 x 128 tests, 64 MB a temporary
    at = sizes[0]
    for size in sizes[1:]:
        vis = order[at:at + size]
        at += size
        vis = vis[active[pkt[vis].long()].any(dim=1)]
        for s0 in range(0, vis.numel(), step):
            v = vis[s0:s0 + step]
            p = pkt[v].long()
            ray_idx = p[:, None] * BP + lane
            gated = ((cmask[v][:, None] >> cols) & 1) != 0  # (m, G*C)
            tri = tri9[sn[v].long()]  # (m, 9, G*C)
            col = lambda a: tri[:, a:a + 3].permute(0, 2, 1)[:, :, None, :]  # noqa: E731
            tm, _, _, _ = geom.moller_trumbore(
                o[ray_idx][:, None], d[ray_idx][:, None], col(0), col(3),
                col(6))  # (m, G*C, BP)
            hit = (gated[:, :, None] & (tm > tmin[ray_idx][:, None])
                   & (tm < tmax[ray_idx][:, None]))
            found = hit.any(dim=1)  # (m, BP)
            first_hit = hit.to(torch.uint8).argmax(dim=1)  # the first True
            upto = gated.cumsum(dim=1)  # gated rows up to each column
            n_tests = torch.where(found, torch.gather(upto, 1, first_hit),
                                  upto[:, -1:])
            act = active[p]
            tests.view(-1, BP)[p] += torch.where(act, n_tests, 0)
            active[p] = act & ~found
    return tests


def _check_visits(pkt, sn, cmask, first, last, o, d, tmin, tri9, state):
    dev = o.device
    _build.check_tensors(dev, [
        ("pkt", pkt, torch.int32, 1), ("sn", sn, torch.int32, 1),
        ("cmask", cmask, torch.int32, 1), ("first", first, torch.int32, 1),
        ("last", last, torch.int32, 1), ("o", o, torch.float32, 2),
        ("d", d, torch.float32, 2), ("tmin", tmin, torch.float32, 1),
        ("tri9", tri9, torch.float32, 3),
    ] + [(name, x, dtype, 1) for name, x, dtype in state])
    n, nv = o.shape[0], pkt.shape[0]
    if any(x.shape != (nv,) for x in (sn, cmask, first, last)):
        raise ValueError("visit list: want pkt, sn, cmask, first, last (V,)")
    if n % BP or o.shape[1] != 3 or d.shape != o.shape or tmin.shape != (n,):
        raise ValueError(f"rays: want o, d (P*{BP}, 3) and tmin (P*{BP},)")
    if any(x.shape != (n,) for _, x, _ in state):
        raise ValueError("per-ray state: want (N,) tensors")
    if tri9.shape[1:] != (9, GROUP * CLUSTER):
        raise ValueError(f"tri9: want (S+1, 9, {GROUP * CLUSTER})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def nearest_visits(pkt, sn, cmask, first, last, o, d, tmin, tri9, best_t,
                   best_code):
    """Run one list of visits; returns updated copies of (best_t, best_code).

    pkt, sn, cmask, first, last (V,) i32: visit v sends packet pkt[v]
    against supernode sn[v], bit k of cmask[v] gating its cluster k; a
    packet's run goes from a `first` flag to the next `last` flag, and a
    packet has at most one run.  o, d (P*BP, 3), tmin (P*BP,) f32; tri9
    (S+1, 9, GROUP*C) f32; best_t (P*BP,) f32, best_code (P*BP,) i32 with
    code = (sn*GROUP + k)*C + row.  A hit is taken where
    ``t >= tmin and t < best``, the lowest row among equal t and the
    earliest cluster and visit first.  Packets with no run keep their
    input values.
    """
    _check_visits(pkt, sn, cmask, first, last, o, d, tmin, tri9,
                  [("best_t", best_t, torch.float32),
                   ("best_code", best_code, torch.int32)])
    if o.device.type == "cpu":
        return nearest_visits_reference(pkt, sn, cmask, first, last, o, d,
                                        tmin, tri9, best_t, best_code)
    bt, bc = best_t.clone(), best_code.clone()
    if pkt.shape[0]:
        # the per-ray merge keys of the blocks that split a run
        keys = torch.empty(o.shape[0], dtype=torch.int64, device=o.device)
        _build.launch(
            "binned", "spray_binned_nearest", o.device, pkt.data_ptr(),
            sn.data_ptr(), cmask.data_ptr(), first.data_ptr(),
            last.data_ptr(), pkt.shape[0], o.data_ptr(), d.data_ptr(),
            tmin.data_ptr(), o.shape[0] // BP, tri9.data_ptr(),
            tri9.shape[0], bt.data_ptr(), bc.data_ptr(), keys.data_ptr())
        launches["binned_nearest_kernel"] += 1
    return bt, bc


def anyhit_visits(pkt, sn, cmask, first, last, o, d, tmin, tmax, tri9, occ,
                  counter=None):
    """The occlusion form of `nearest_visits`: returns an updated copy of
    occ (P*BP,) i32; a hit is any ``tmin < t < tmax`` on a lane not yet
    occluded.  counter: optional (1,) int64 CUDA tensor that receives the
    ray-triangle tests the kernel did.  Its blocks split a run and a lane
    stops at its flag, which another block may have set, so the count
    depends on the order the blocks ran in; `anyhit_serial_tests` counts
    what the serial order needs."""
    _check_visits(pkt, sn, cmask, first, last, o, d, tmin, tri9,
                  [("tmax", tmax, torch.float32), ("occ", occ, torch.int32)])
    if o.device.type == "cpu":
        return anyhit_visits_reference(pkt, sn, cmask, first, last, o, d,
                                       tmin, tmax, tri9, occ)
    oc = occ.clone()
    if pkt.shape[0]:
        _build.launch(
            "binned", "spray_binned_anyhit", o.device, pkt.data_ptr(),
            sn.data_ptr(), cmask.data_ptr(), first.data_ptr(),
            last.data_ptr(), pkt.shape[0], o.data_ptr(), d.data_ptr(),
            tmin.data_ptr(), tmax.data_ptr(), o.shape[0] // BP,
            tri9.data_ptr(), tri9.shape[0], oc.data_ptr(),
            _build.check_counter(counter, o.device))
        launches["binned_anyhit_kernel"] += 1
    return oc


# ---------------------------------------------------------------------------
# Chase loop: band selection + visits until the commit invariant holds
# ---------------------------------------------------------------------------


def _sorted_order(entry, k):
    """Front-to-back supernode order per packet, padded by (-S) % k + k
    columns so every K-wide band is in range.  Sorted ONCE per phase; bands
    are then just slices.  The sort is stable: many entries tie at +inf."""
    s = entry.shape[1]
    order = torch.argsort(entry, dim=1, stable=True)
    ent_sorted = torch.gather(entry, 1, order)
    pad = (-s) % k + k
    order = F.pad(order.to(torch.int32), (0, pad), value=0)
    ent_sorted = F.pad(ent_sorted, (0, pad), value=INF)
    return order, ent_sorted


def _visit_flags(p, k, device):
    pkt_of = torch.arange(p, dtype=torch.int32, device=device).repeat_interleave(k)
    col = torch.arange(k, dtype=torch.int32, device=device)
    first = (col == 0).to(torch.int32).repeat(p)
    last = (col == k - 1).to(torch.int32).repeat(p)
    return pkt_of, first, last


def _phase_sizes(p, k, s):
    """Cascade of (packets, band width) pairs: the list shrinks 4x per phase
    as rays retire, so tail rounds (one stubborn packet marching the whole
    scene) run on tiny lists instead of P*K null visits per round."""
    sizes = []
    cur = p
    kk = k
    while True:
        sizes.append((cur, min(kk, max(s, 1))))
        if cur == 1:
            break
        cur = max(cur // 4, 1)
        kk = min(kk * 2, 32)
    return tuple(sizes)


class _Band:
    """The per-phase constants of a chase: the first p_sub packets' rays,
    their frustums, sorted supernode order and visit flags."""

    def __init__(self, tri9, cbox, sbox, o, d, tmin, tmax, p_sub, k):
        nsub = p_sub * BP
        self.tri9, self.cbox, self.k, self.p = tri9, cbox, k, p_sub
        self.s = sbox.shape[0]
        self.s_null = tri9.shape[0] - 1
        self.o = o[:nsub].contiguous()
        self.d = d[:nsub].contiguous()
        self.tmin = tmin[:nsub].contiguous()
        self.ivals = packet_intervals(self.o, self.d, self.tmin, tmax[:nsub])
        entry = supernode_entries(self.ivals, sbox)  # (p_sub, S)
        self.order, self.ent_sorted = _sorted_order(entry, k)
        self.flags = _visit_flags(p_sub, k, o.device)

    def nxt_of(self, r):
        """(p_sub,) smallest unprocessed entry after r rounds.  The column
        is clamped to S - 1 and masked by r*k < S, as the reference's
        clamping dynamic slice."""
        if r * self.k < self.s:
            return self.ent_sorted[:, min(r * self.k, self.s - 1)]
        return torch.full_like(self.ent_sorted[:, 0], INF)

    def visits(self, r, upper):
        """Round r's visit list: band r of every packet, culled by the
        packet's upper bound."""
        k = self.k
        sn = self.order[:, r * k:(r + 1) * k]
        ent = self.ent_sorted[:, r * k:(r + 1) * k]
        assert sn.shape[1] == k, "the band padding keeps every slice in range"
        valid = ent < upper[:, None]
        snv = torch.where(valid, sn, self.s_null)
        cmask = torch.where(
            valid, cluster_masks(self.ivals, self.cbox, snv, upper), 0)
        pkt_of, first, last = self.flags
        return (pkt_of, snv.reshape(-1).contiguous(),
                cmask.reshape(-1).contiguous(), first, last)


def _chase(band, upper_of, ray_live_of, visit, carry, cap_next, last_phase,
           stats):
    """Chase rounds until the commit invariant holds on the band's packets,
    or few enough rays remain for the next (smaller) phase.  Each round
    reads one flag from the device.  Returns (carry, rounds)."""

    def live_of(carry, r):
        nxt = band.nxt_of(r)
        work = (nxt < upper_of(carry)).any()
        if last_phase:
            return work
        return work & (ray_live_of(carry, nxt) > cap_next)

    r = 0
    while True:
        stats["syncs"] += 1
        if not bool(live_of(carry, r)):
            return carry, r
        carry = visit(carry, band.visits(r, upper_of(carry)))
        stats["rounds"] += 1
        stats["visits"] += band.p * band.k
        r += 1


def _phase_nearest(tri9, cbox, sbox, state, p_sub, k, cap_next, last_phase,
                   stats):
    """One phase of the nearest cascade over the first p_sub packets.
    Returns the state with best t / code and t_front updated."""
    o, d, t_front, best_t, best_code, idx = state
    nsub = p_sub * BP
    band = _Band(tri9, cbox, sbox, o, d, t_front, best_t, p_sub, k)
    tf = t_front[:nsub].view(p_sub, BP)

    def upper_of(carry):
        return carry[0].view(p_sub, BP).amax(dim=1)

    def ray_live_of(carry, nxt):
        # per ray: done once no unprocessed supernode can beat its best
        bt = carry[0].view(p_sub, BP)
        return (bt > torch.maximum(nxt[:, None], tf)).sum()

    def visit(carry, vlist):
        return nearest_visits(*vlist, band.o, band.d, band.tmin, tri9, *carry)

    carry = (best_t[:nsub].contiguous(), best_code[:nsub].contiguous())
    (bt, bc), r = _chase(band, upper_of, ray_live_of, visit, carry, cap_next,
                         last_phase, stats)
    # advance every ray's processed front to the min unprocessed entry
    t_front, best_t, best_code = (x.clone() for x in (t_front, best_t,
                                                     best_code))
    t_front[:nsub] = torch.maximum(tf, band.nxt_of(r)[:, None]).view(-1)
    best_t[:nsub] = bt
    best_code[:nsub] = bc
    return (o, d, t_front, best_t, best_code, idx)


def _phase_anyhit(tri9, cbox, sbox, state, p_sub, k, cap_next, last_phase,
                  stats):
    o, d, t_front, tmax_eff, occ_flat, idx = state
    nsub = p_sub * BP
    # occluded rays carry an empty window so they leave the frustum hull
    win = torch.where(occ_flat[:nsub] != 0, 0.0, tmax_eff[:nsub])
    band = _Band(tri9, cbox, sbox, o, d, t_front, win, p_sub, k)
    winb = win.view(p_sub, BP)
    tf = t_front[:nsub].view(p_sub, BP)

    def window(occ):
        return torch.where(occ.view(p_sub, BP) != 0, 0.0, winb)

    def upper_of(occ):
        return window(occ).amax(dim=1)

    def ray_live_of(occ, nxt):
        return (window(occ) > torch.maximum(nxt[:, None], tf)).sum()

    def visit(occ, vlist):
        return anyhit_visits(*vlist, band.o, band.d, band.tmin, win, tri9, occ)

    occ, r = _chase(band, upper_of, ray_live_of, visit,
                    occ_flat[:nsub].contiguous(), cap_next, last_phase, stats)
    t_front, occ_flat = t_front.clone(), occ_flat.clone()
    t_front[:nsub] = torch.maximum(tf, band.nxt_of(r)[:, None]).view(-1)
    occ_flat[:nsub] = occ
    return (o, d, t_front, tmax_eff, occ_flat, idx)


def _compact(state, done):
    """Stable-partition rays: live first.  Keeps the coherence order of the
    live set (the initial Morton/octant sort) intact."""
    perm = torch.argsort(done, stable=True)
    return tuple(a[perm] for a in state)


def _scatter_back(idx, x):
    """Un-permute: out[idx] = x (every index once; never an add)."""
    out = torch.zeros_like(x)
    out[idx] = x
    return out


def _binned_nearest(scene_arrays, o, d, tmin, tmax_eff, k, stats):
    """Flat in, flat out (input ray order); len(o) % BP == 0."""
    tri9, cbox, sbox = scene_arrays
    npad = o.shape[0]
    best_code = torch.full((npad,), -1, dtype=torch.int32, device=o.device)
    idx = torch.arange(npad, device=o.device)
    state = (o, d, tmin, tmax_eff, best_code, idx)
    sizes = _phase_sizes(npad // BP, k, sbox.shape[0])
    for i, (p_sub, kk) in enumerate(sizes):
        last_phase = i == len(sizes) - 1
        cap_next = 0 if last_phase else sizes[i + 1][0] * BP
        state = _phase_nearest(tri9, cbox, sbox, state, p_sub, kk, cap_next,
                               last_phase, stats)
        if not last_phase:
            _, _, t_front, best_t, _, _ = state
            state = _compact(state, (best_t <= t_front).to(torch.int32))
    _, _, _, best_t, best_code, idx = state
    return _scatter_back(idx, best_t), _scatter_back(idx, best_code)


def _binned_anyhit(scene_arrays, o, d, tmin, tmax_eff, k, stats):
    tri9, cbox, sbox = scene_arrays
    npad = o.shape[0]
    occ = torch.zeros(npad, dtype=torch.int32, device=o.device)
    idx = torch.arange(npad, device=o.device)
    state = (o, d, tmin, tmax_eff, occ, idx)
    sizes = _phase_sizes(npad // BP, k, sbox.shape[0])
    for i, (p_sub, kk) in enumerate(sizes):
        last_phase = i == len(sizes) - 1
        cap_next = 0 if last_phase else sizes[i + 1][0] * BP
        state = _phase_anyhit(tri9, cbox, sbox, state, p_sub, kk, cap_next,
                              last_phase, stats)
        if not last_phase:
            _, _, t_front, tmx, occ_f, _ = state
            live = (occ_f == 0) & (tmx > t_front)
            state = _compact(state, (~live).to(torch.int32))
    _, _, _, _, occ, idx = state
    return _scatter_back(idx, occ)


# ---------------------------------------------------------------------------
# Wavefront coherence sort
# ---------------------------------------------------------------------------


def _spread3(v):
    """Spread 10 bits to every 3rd bit (int32)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def sort_key(o, d, tmin, tmax, world_lo, world_hi):
    """Coherence key (30 bits): direction octant (3) | Morton code of the
    scene-normalized origin (27); dead rays sort last.

    Wavefront tracing must re-create the ray coherence a recursive tracer
    gets for free: scrambled secondary rays make packet frustums cover the
    whole scene and the chase loop degenerate.  The origin is clamped in
    float before the cast, which equals the reference's cast-then-clip on
    every finite value and keeps far-away origins out of int overflow.
    """
    ext = torch.clamp(world_hi - world_lo, min=1e-12)
    q = torch.clamp((o - world_lo) / ext * 511.0, 0, 511).to(torch.int32)
    morton = (
        _spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
        | (_spread3(q[:, 2]) << 2)
    )
    octant = (
        (d[:, 0] < 0).to(torch.int32)
        | ((d[:, 1] < 0).to(torch.int32) << 1)
        | ((d[:, 2] < 0).to(torch.int32) << 2)
    )
    key = (octant << 27) | morton
    return torch.where(tmax <= tmin, 2**31 - 1, key)


# ---------------------------------------------------------------------------
# Intersector
# ---------------------------------------------------------------------------


class BinnedIntersector:
    """Scene-global binned cull+visit tracer.

    k: supernode band width per chase round (correctness does not depend
    on it: the loop chases until the commit invariant holds).
    sort: re-pack the wavefront by (direction octant, origin Morton) before
    tracing; results are identical, only packet coherence changes.
    stats: host-side counts of the trace loops (`new_stats`).
    """

    def __init__(self, scene, k=4, sort=True, device=None):
        device = resolve_device(device)
        b = BinnedScene(np.asarray(scene.vertices), np.asarray(scene.faces))
        self._init(scene, b.arrays(), device, k=k, sort=sort)

    @classmethod
    def from_arrays(cls, scene, arrays, device=None, **kw):
        """Intersector over a build made elsewhere: the dict of the six
        `BinnedScene.FIELDS` arrays (this package's or the reference's);
        `kw` as the constructor's options."""
        obj = cls.__new__(cls)
        obj._init(scene, arrays, resolve_device(device), **kw)
        return obj

    def _init(self, scene, arrays, device, k=4, sort=True):
        def dev(name, dtype):
            return torch.as_tensor(
                np.ascontiguousarray(arrays[name], dtype), device=device)

        self.device = device
        self.tri9 = dev("tri9", np.float32)
        self.cbox = dev("cbox", np.float32)
        self.sbox = dev("sbox", np.float32)
        self.tri_ids = dev("tri_ids", np.int32)
        self.world_lo = dev("world_lo", np.float32)
        self.world_hi = dev("world_hi", np.float32)
        self.v0, self.e1, self.e2 = tri_soa_from_scene(scene, device)
        self.k = min(k, self.sbox.shape[0])
        self.sort = sort
        self.stats = new_stats()

    def _clamp_exit(self, o, d, tmax):
        """Clamp each ray's window to its world-AABB exit: geometry cannot
        lie beyond the scene hull, so escaping rays retire the moment their
        processed front passes the hull.  The reciprocal keeps the
        reference's rule (a component with |d| <= 1e-12, of either sign,
        becomes +1e-12); a ray that misses the hull gets window 0."""
        eps = 1e-12
        inv = 1.0 / torch.where(d.abs() > eps, d, eps)
        t0 = (self.world_lo[None] - o) * inv
        t1 = (self.world_hi[None] - o) * inv
        t_exit = torch.maximum(t0, t1).amin(dim=1)
        t_enter = torch.minimum(t0, t1).amax(dim=1)
        # relative + absolute slack: never clip a true boundary hit
        lim = t_exit * (1.0 + 1e-4) + 1e-4
        hit_box = (t_enter <= t_exit) & (t_exit > 0)
        return torch.minimum(tmax, torch.where(hit_box, lim, 0.0))

    def _packed(self, o, d, tmin, tmax):
        """The wavefront as the trace cores take it: windows clamped to the
        hull, padded to whole packets with empty-window rays, coherence
        sorted.  Returns (o, d, tmin, tmax, perm or None)."""
        rays = pad_rays(o, d, tmin, self._clamp_exit(o, d, tmax), BP)
        if not self.sort:
            return (*rays, None)
        perm = torch.argsort(
            sort_key(*rays, self.world_lo, self.world_hi), stable=True)
        return (*(x[perm].contiguous() for x in rays), perm)

    def _run_nearest(self, o_, d_, tmin_, tmax_):
        return _binned_nearest((self.tri9, self.cbox, self.sbox), o_, d_,
                               tmin_, tmax_, self.k, self.stats)

    def _run_anyhit(self, o_, d_, tmin_, tmax_):
        return _binned_anyhit((self.tri9, self.cbox, self.sbox), o_, d_,
                              tmin_, tmax_, self.k, self.stats)

    def intersect(self, o, d, tmin, tmax):
        n = o.shape[0]
        self.stats["calls"] += 1
        *rays, perm = self._packed(o, d, tmin, tmax)
        bt, bc = self._run_nearest(*rays)
        if perm is not None:
            bt, bc = _scatter_back(perm, bt), _scatter_back(perm, bc)
        bt, bc = bt[:n], bc[:n]
        prim = torch.where(bc >= 0, self.tri_ids[torch.clamp(bc, min=0).long()],
                           -1)
        t, u, v, valid = attrs_for_prims(self.v0, self.e1, self.e2, prim, o,
                                         d, bt, tmax)
        return Hits(t=torch.where(valid, t, tmax), prim=prim, u=u, v=v,
                    valid=valid)

    def occluded(self, o, d, tmax):
        self.stats["calls"] += 1
        *rays, perm = self._packed(o, d, torch.zeros_like(tmax), tmax)
        occ = self._run_anyhit(*rays)
        if perm is not None:
            occ = _scatter_back(perm, occ)
        return occ[: o.shape[0]] != 0
