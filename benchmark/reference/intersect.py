"""A plain ray/triangle intersector in PyTorch: Möller–Trumbore tests of
every triangle whose boxes a ray enters, with no traversal order.

Triangles are sorted by the Morton code of their centroids and cut into
groups of GROUP consecutive triangles, the groups into supergroups of
GROUP groups.  A ray is slab-tested against every supergroup box, then
against the groups of the supergroups it enters, then Möller–Trumbore
tested against the triangles of the groups it enters.  The nearest hit
breaks ties of t to the lowest triangle id.  The boxes only skip tests
that cannot hit, so the answers are those of testing every triangle.
Nothing here shares code or data with the program under test.
"""

from __future__ import annotations

import torch

GROUP = 32
EPS = 1e-7
PAIR_BUDGET = 1 << 24  # (ray, box) or (ray, triangle) pairs held at once


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def moller_trumbore(o, d, v0, e1, e2):
    """(t, ok) of the Möller–Trumbore test; t is +inf where it misses."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) > EPS
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return torch.where(ok, t, torch.full_like(t, float("inf"))), ok


def _spread10(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


class BoxCullIntersector:
    """Intersector over one triangle soup (vertices (V, 3), faces (F, 3)
    tensors on one device, in the dtype the tests run in)."""

    def __init__(self, vertices, faces):
        dev = vertices.device
        tv = vertices[faces.reshape(-1).long()].reshape(-1, 3, 3)
        nf = tv.shape[0]
        cen = tv.float().mean(dim=1)
        lo, hi = cen.amin(0), cen.amax(0)
        q = ((cen - lo) / torch.clamp(hi - lo, min=1e-30) * 1023).long()
        code = (_spread10(q[:, 0]) << 2) | (_spread10(q[:, 1]) << 1) \
            | _spread10(q[:, 2])
        order = torch.sort(code, stable=True).indices
        per_super = GROUP * GROUP
        n_pad = -(-nf // per_super) * per_super
        order = torch.cat([order, torch.full((n_pad - nf,), -1,
                                             dtype=torch.int64, device=dev)])
        self.tri = order  # (n_pad,) triangle id of each sorted slot, -1 pad
        safe = torch.clamp(order, min=0)
        sv = tv[safe]
        self.v0 = sv[:, 0].contiguous()
        self.e1 = (sv[:, 1] - sv[:, 0]).contiguous()
        self.e2 = (sv[:, 2] - sv[:, 0]).contiguous()
        pad = (order < 0)[:, None]
        inf = torch.tensor(float("inf"), dtype=tv.dtype, device=dev)
        # boxes grown by a millionth of the scene's extent, so that no
        # rounding of a slab test culls a triangle the ray hits
        grow = float((tv.amax((0, 1)) - tv.amin((0, 1))).amax()) * 1e-6
        tlo = torch.where(pad, inf, sv.amin(dim=1) - grow)
        thi = torch.where(pad, -inf, sv.amax(dim=1) + grow)
        self.g_lo = tlo.reshape(-1, GROUP, 3).amin(1)
        self.g_hi = thi.reshape(-1, GROUP, 3).amax(1)
        self.s_lo = self.g_lo.reshape(-1, GROUP, 3).amin(1)
        self.s_hi = self.g_hi.reshape(-1, GROUP, 3).amax(1)

    @staticmethod
    def _slab(o, inv, tmin, tmax, lo, hi):
        """Rays (..., 3) against boxes (..., 3), broadcast: entered?"""
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        enter = torch.maximum(torch.minimum(t0, t1).amax(-1), tmin)
        leave = torch.minimum(torch.maximum(t0, t1).amin(-1), tmax)
        return (enter <= leave) & (lo <= hi).all(-1)

    def _candidates(self, o, d, tmin, tmax):
        """Yields (ray index, sorted slot) pairs of every triangle in a group
        whose boxes the ray enters, a block of rays at a time."""
        n = o.shape[0]
        tiny = torch.tensor(1e-30, dtype=d.dtype, device=d.device)
        d_safe = torch.where(d.abs() < tiny, torch.copysign(tiny, d), d)
        inv = 1.0 / d_safe
        n_super = self.s_lo.shape[0]
        block = max(1, PAIR_BUDGET // (n_super * 3))
        ar = torch.arange(GROUP, device=o.device)
        for r0 in range(0, n, block):
            sl = slice(r0, min(n, r0 + block))
            oo, ii, t0, t1 = o[sl], inv[sl], tmin[sl], tmax[sl]
            hit = self._slab(oo[:, None], ii[:, None], t0[:, None],
                             t1[:, None], self.s_lo[None], self.s_hi[None])
            ray, sup = torch.nonzero(hit, as_tuple=True)
            for p0 in range(0, ray.shape[0], PAIR_BUDGET // GROUP):
                r = ray[p0:p0 + PAIR_BUDGET // GROUP]
                g = (sup[p0:p0 + PAIR_BUDGET // GROUP, None] * GROUP
                     + ar).reshape(-1)
                r = r.repeat_interleave(GROUP)
                hit2 = self._slab(oo[r], ii[r], t0[r], t1[r], self.g_lo[g],
                                  self.g_hi[g])
                r, g = r[hit2], g[hit2]
                for q0 in range(0, r.shape[0], PAIR_BUDGET // GROUP):
                    rr = r[q0:q0 + PAIR_BUDGET // GROUP].repeat_interleave(GROUP)
                    ss = (g[q0:q0 + PAIR_BUDGET // GROUP, None] * GROUP
                          + ar).reshape(-1)
                    yield rr + r0, ss

    def intersect(self, o, d, tmin, tmax):
        """Nearest hit in [tmin, tmax]: (t, prim) with prim -1 and t = tmax
        on a miss."""
        n = o.shape[0]
        dev = o.device
        best_t = torch.full((n,), float("inf"), dtype=torch.float32,
                            device=dev)
        cands = []
        for r, s in self._candidates(o, d, tmin, tmax):
            t, ok = moller_trumbore(o[r], d[r], self.v0[s], self.e1[s],
                                    self.e2[s])
            inside = ok & (self.tri[s] >= 0) & (t >= tmin[r]) & (t <= tmax[r])
            r, s, t = r[inside], s[inside], t[inside].float()
            best_t.scatter_reduce_(0, r, t, "amin")
            cands.append((r, s, t))
        best_prim = torch.full((n,), 1 << 62, dtype=torch.int64, device=dev)
        for r, s, t in cands:
            tie = t == best_t[r]
            best_prim.scatter_reduce_(0, r[tie], self.tri[s[tie]], "amin")
        valid = torch.isfinite(best_t)
        prim = torch.where(valid, best_prim, -1)
        return torch.where(valid, best_t.to(o.dtype), tmax), prim

    def occluded(self, o, d, tmax):
        """Any hit with t in (0, tmax)."""
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        zero = torch.zeros_like(tmax)
        for r, s in self._candidates(o, d, zero, tmax):
            t, ok = moller_trumbore(o[r], d[r], self.v0[s], self.e1[s],
                                    self.e2[s])
            blk = ok & (self.tri[s] >= 0) & (t > 0.0) & (t < tmax[r])
            occ[r[blk]] = True
        return occ
