"""Stackful BVH traversal over a `FlatBVH` as batched torch ops
(counterpart of ``spray_tpu/bvh/traverse.py``).

The reference walks each ray with its own `lax.while_loop` over a
fixed-depth stack, vmapped over the wavefront.  Here the wavefront walks
together: every step pops one node for each live ray, tests the node's B
child boxes, intersects the hit leaf runs and pushes the hit internal
children, with each ray's stack a row of an (N, STACK_DEPTH) tensor.  A
ray's sequence of pops, tests and updates is the reference's, so the
results agree bit for bit where the arithmetic does:

  - the child boxes are tested once per pop against [tmin, min(tmax, best_t))
    with best_t as it was at the pop;
  - the leaf runs are intersected in child-slot order j = 0..B-1, each a
    gather of `leaf_size` rows with the gate ``t >= tmin & t < best_t &
    id >= 0``, the first minimum of a leaf winning, and the update
    ``t < best_t``: so the first slot that reaches the node's least t wins;
  - the internal children are pushed in slot order (popped last first); a
    push beyond the stack is dropped and a pop beyond it reads its top,
    as JAX's scatter and gather do;
  - the any-hit stops a ray once it has found a hit, after the node.

It is not a Pallas kernel in the reference, so it owes no CUDA kernel: it
runs on whatever device its tensors are on, with one host sync a step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import geom
from ..core.device import resolve_device
from ..core.types import Hits
from .builder import FlatBVH, build_bvh, reordered_tri_arrays

STACK_DEPTH = 96


@dataclasses.dataclass(frozen=True)
class DeviceBVH:
    """FlatBVH + leaf-ordered triangle SoA as tensors on one device."""

    child_lo: torch.Tensor  # (N, B, 3) f32
    child_hi: torch.Tensor  # (N, B, 3) f32
    child_node: torch.Tensor  # (N, B) i32
    child_count: torch.Tensor  # (N, B) i32
    v0: torch.Tensor  # (Tp, 3) f32
    e1: torch.Tensor
    e2: torch.Tensor
    orig_id: torch.Tensor  # (Tp,) i32, -1 padding
    leaf_size: int

    @classmethod
    def build(cls, vertices, faces, leaf_size=16, branching=8, device=None):
        bvh = build_bvh(vertices, faces, leaf_size=leaf_size, branching=branching)
        v0, e1, e2, orig = reordered_tri_arrays(vertices, faces, bvh)
        return cls.from_flat(bvh, v0, e1, e2, orig, device=device)

    @classmethod
    def from_flat(cls, bvh: FlatBVH, v0, e1, e2, orig, device=None):
        device = resolve_device(device)

        def put(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=device)

        return cls(child_lo=put(bvh.child_lo), child_hi=put(bvh.child_hi),
                   child_node=put(bvh.child_node),
                   child_count=put(bvh.child_count), v0=put(v0), e1=put(e1),
                   e2=put(e2), orig_id=put(orig), leaf_size=bvh.leaf_size)


def _leaf_hits(bvh, first, o, d, tmin, best_t):
    """Nearest gated hit of each (ray, leaf) pair in its leaf_size rows
    starting at `first` (P,): (t, id, u, v), t = +inf where none."""
    rows = first[:, None] + torch.arange(bvh.leaf_size, device=first.device)
    ids = bvh.orig_id[rows]
    t, u, v, ok = geom.moller_trumbore(o[:, None], d[:, None], bvh.v0[rows],
                                       bvh.e1[rows], bvh.e2[rows])
    ok = ok & (ids >= 0) & (t >= tmin[:, None]) & (t < best_t[:, None])
    t = torch.where(ok, t, torch.full_like(t, geom.INF))
    j = torch.argmin(t, dim=1, keepdim=True)  # the first minimum
    pick = lambda x: torch.gather(x, 1, j)[:, 0]  # noqa: E731
    return pick(t), pick(ids), pick(u), pick(v)


def traverse(bvh, o, d, tmin, tmax, any_hit=False):
    """Nearest-hit (or any-hit) traversal of a wavefront: o, d (N, 3),
    tmin, tmax (N,) f32.  Returns (t, prim, u, v, found), (N,) each: t is
    tmax, prim -1 and u = v = 0 where nothing was found.  A lane whose
    window is empty or NaN can pass no leaf gate: it keeps those values
    without a walk."""
    n, dev = o.shape[0], o.device
    best_t, found = tmax.clone(), torch.zeros(n, dtype=torch.bool, device=dev)
    best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u, best_v = torch.zeros_like(tmax), torch.zeros_like(tmax)
    idx = torch.nonzero(tmax > tmin).view(-1)
    if idx.numel() == 0:
        return best_t, best, best_u, best_v, found
    inv_d = 1.0 / torch.where(torch.abs(d) > 1e-12, d, torch.full_like(d, 1e-12))
    m, b = idx.numel(), bvh.child_node.shape[1]
    # per live ray: its inputs, its best so far and its stack (one spare
    # column takes the dropped pushes), compacted as rays finish
    rays = [x[idx] for x in (o, d, tmin, tmax, o * inv_d, inv_d)]
    state = [x[idx] for x in (best_t, best, best_u, best_v, found)]
    stack = torch.zeros(m, STACK_DEPTH + 1, dtype=torch.int32, device=dev)
    sp = torch.ones(m, dtype=torch.int64, device=dev)
    while True:
        r_o, r_d, r_lo, r_hi, r_roinv, r_invd = rays
        bt, bp, bu, bv, f = state
        m = idx.numel()
        sp = sp - 1
        node = torch.gather(stack, 1, sp.clamp(max=STACK_DEPTH - 1)[:, None])[:, 0].long()
        _, hit = geom.ray_aabb(r_roinv[:, None], r_invd[:, None],
                               bvh.child_lo[node], bvh.child_hi[node],
                               r_lo[:, None], torch.minimum(r_hi, bt)[:, None])
        kind = bvh.child_node[node]
        hit = hit & (kind != -1)
        # the leaves, all slots at once: the first slot reaching the least
        # gated t is what the reference's slot-order updates keep
        ray, j = torch.nonzero(hit & (kind <= -2), as_tuple=True)
        t_leaf = torch.full((m, b), geom.INF, device=dev)
        if ray.numel():
            lt, lid, lu, lv = _leaf_hits(bvh, -(kind[ray, j] + 2), r_o[ray],
                                         r_d[ray], r_lo[ray], bt[ray])
            t_leaf[ray, j] = lt
            l_id = torch.zeros(m, b, dtype=torch.int32, device=dev)
            l_u, l_v = torch.zeros(m, b, device=dev), torch.zeros(m, b, device=dev)
            l_id[ray, j], l_u[ray, j], l_v[ray, j] = lid, lu, lv
            jj = torch.argmin(t_leaf, dim=1, keepdim=True)
            pick = lambda x: torch.gather(x, 1, jj)[:, 0]  # noqa: E731
            nt = pick(t_leaf)
            upd = nt < bt
            bt = torch.where(upd, nt, bt)
            bp = torch.where(upd, pick(l_id), bp)
            bu = torch.where(upd, pick(l_u), bu)
            bv = torch.where(upd, pick(l_v), bv)
            f = f | upd
        # the internal children, pushed in slot order
        push = hit & (kind >= 0)
        pos = sp[:, None] + torch.cumsum(push, dim=1) - push.long()
        pos = torch.where(push & (pos < STACK_DEPTH), pos,
                          torch.full_like(pos, STACK_DEPTH))
        stack.scatter_(1, pos, kind)
        sp = sp + push.sum(dim=1)
        state = [bt, bp, bu, bv, f]
        go = (sp > 0) & ~f if any_hit else sp > 0
        done = ~go
        n_done = int(done.sum())  # the step's host sync
        if n_done:
            out = idx[done]
            for full, part in zip((best_t, best, best_u, best_v, found), state):
                full[out] = part[done]
            if n_done == m:
                break
            idx, stack, sp = idx[go], stack[go], sp[go]
            rays = [x[go] for x in rays]
            state = [x[go] for x in state]
    return best_t, best, best_u, best_v, found


class BVHIntersector:
    """Drop-in intersector (the interface of `BruteIntersector`) over a
    DeviceBVH: the reference's CPU default above 256 triangles."""

    def __init__(self, scene=None, bvh: DeviceBVH = None, leaf_size=16,
                 branching=8, device=None):
        if bvh is None:
            bvh = DeviceBVH.build(np.asarray(scene.vertices),
                                  np.asarray(scene.faces), leaf_size=leaf_size,
                                  branching=branching, device=device)
        self.bvh = bvh

    def intersect(self, o, d, tmin, tmax):
        t, prim, u, v, found = traverse(self.bvh, o, d, tmin, tmax)
        return Hits(t=torch.where(found, t, tmax),
                    prim=torch.where(found, prim, -1), u=u, v=v, valid=found)

    def occluded(self, o, d, tmax):
        return traverse(self.bvh, o, d, torch.zeros_like(tmax), tmax,
                        any_hit=True)[4]
