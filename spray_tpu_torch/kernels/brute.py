"""Brute-force ray x triangle intersection (nearest hit and any hit) in two
hand-written CUDA kernels, with their plain PyTorch versions.

Counterpart of ``spray_tpu/kernels/brute.py``: the fast path for small
scenes, where a BVH would be overhead.  The TPU kernels hold an (8, 128) ray
tile in registers and stream the triangle table from SMEM; the CUDA kernels
(``csrc/brute.cu``) queue a block's live rays, one a thread, and stage the
table through shared memory packed as 16-byte vectors (`pack_table`); the
any-hit kernel stops a ray at its first hit and a block once all its rays
are occluded.  The contract is the reference's:

  - nearest: triangles in row order with a strict ``t < best`` and
    ``t >= tmin``, so the lowest row wins an exact tie; rows with id < 0
    never hit; returns (t, prim, u, v) with t = tmax, prim = -1, u = v = 0
    on a miss (dead lanes included);
  - any-hit: any triangle with ``tmin < t < tmax``.

Each wrapper sends a CPU tensor to the plain version and launches the CUDA
kernel for a CUDA tensor (or raises); there is no fallback between them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import geom
from ..core.device import resolve_device
from ..core.types import Hits
from . import _build

# launches of each CUDA kernel by its wrapper (the plain versions never count)
launches = {"brute_nearest_kernel": 0, "brute_anyhit_kernel": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _check(tri9, ids, o, d, tmin, tmax):
    _build.check_tensors(o.device, [
        ("tri9", tri9, torch.float32, 2), ("ids", ids, torch.int32, 1),
        ("o", o, torch.float32, 2), ("d", d, torch.float32, 2),
        ("tmin", tmin, torch.float32, 1), ("tmax", tmax, torch.float32, 1),
    ])
    n = o.shape[0]
    if tri9.shape[1] != 9 or ids.shape[0] != tri9.shape[0]:
        raise ValueError("want tri9 (T, 9) and ids (T,)")
    if (o.shape[1] != 3 or d.shape != o.shape or tmin.shape != (n,)
            or tmax.shape != (n,)):
        raise ValueError("rays: want o, d (N, 3) and tmin, tmax (N,)")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {o.device}")


def _mt_chunks(tri9, o, d, budget=1 << 22):
    """Yield (slice, t, u, v, ok) of rays against the whole table, (n, T)
    each, in ray chunks of about `budget` ray-triangle pairs."""
    v0, e1, e2 = tri9[None, :, 0:3], tri9[None, :, 3:6], tri9[None, :, 6:9]
    step = max(1, budget // max(1, tri9.shape[0]))
    for s in range(0, o.shape[0], step):
        sl = slice(s, s + step)
        yield (sl, *geom.moller_trumbore(o[sl, None], d[sl, None], v0, e1, e2))


def brute_nearest_reference(tri9, ids, o, d, tmin, tmax):
    """Plain PyTorch version of `brute_nearest_kernel`.  The first minimum
    of the gated t over the rows is what the kernel's in-order strict
    ``t < best`` loop keeps."""
    n = o.shape[0]
    t_out, prim = tmax.clone(), torch.full((n,), -1, dtype=torch.int32,
                                           device=o.device)
    u_out, v_out = torch.zeros_like(tmax), torch.zeros_like(tmax)
    if tri9.shape[0] == 0:
        return t_out, prim, u_out, v_out
    for sl, t, u, v, ok in _mt_chunks(tri9, o, d):
        ok = ok & (t >= tmin[sl, None]) & (t < tmax[sl, None]) & (ids >= 0)
        t = torch.where(ok, t, torch.full_like(t, geom.INF))
        row = torch.argmin(t, dim=1, keepdim=True)  # first on ties
        hit = ok.any(dim=1)
        pick = lambda x: torch.gather(x, 1, row)[:, 0]  # noqa: E731
        t_out[sl] = torch.where(hit, pick(t), tmax[sl])
        prim[sl] = torch.where(hit, ids[row[:, 0]], -1)
        u_out[sl] = torch.where(hit, pick(u), 0.0)
        v_out[sl] = torch.where(hit, pick(v), 0.0)
    return t_out, prim, u_out, v_out


def brute_anyhit_reference(tri9, ids, o, d, tmin, tmax):
    """Plain PyTorch version of `brute_anyhit_kernel`; returns occ (N,) i32."""
    occ = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    if tri9.shape[0] == 0:
        return occ
    for sl, t, _, _, ok in _mt_chunks(tri9, o, d):
        ok = ok & (t > tmin[sl, None]) & (t < tmax[sl, None]) & (ids >= 0)
        occ[sl] = ok.any(dim=1).to(torch.int32)
    return occ


def anyhit_serial_tests(tri9, ids, o, d, tmin, tmax):
    """Ray-triangle tests, per ray ((N,) int64), that the serial order of
    the any-hit needs: the bound of `brute_anyhit_kernel` counts these.  A
    dead lane (!(tmax > tmin), NaN included) needs none; any other ray
    tests every row with id >= 0 up to and including the first that
    occludes it (tmin < t < tmax), or all of them if none does."""
    tests = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    live = torch.nonzero(tmax > tmin).view(-1)
    if tri9.shape[0] == 0 or live.numel() == 0:
        return tests
    real = ids >= 0
    upto = torch.cumsum(real.to(torch.int64), dim=0)  # real rows up to each
    lo, hi = tmin[live], tmax[live]
    for sl, t, _, _, ok in _mt_chunks(tri9, o[live], d[live]):
        hit = ok & (t > lo[sl, None]) & (t < hi[sl, None]) & real
        first = hit.to(torch.uint8).argmax(dim=1)  # the first True
        tests[live[sl]] = torch.where(hit.any(dim=1), upto[first], upto[-1])
    return tests


def pack_table(tri9, ids):
    """The (T, 12) f32 table the kernels read: rows `[v0 0 | e1 0 | e2 id]`,
    three 16-byte vectors, the id's int32 bits in the twelfth word."""
    zero = tri9.new_zeros(tri9.shape[0], 1)
    return torch.cat([tri9[:, 0:3], zero, tri9[:, 3:6], zero, tri9[:, 6:9],
                      ids.view(torch.float32)[:, None]], dim=1)


def _check_tri12(tri9, tri12, device):
    if tri12 is not None:
        _build.check_tensors(device, [("tri12", tri12, torch.float32, 2)])
        if tri12.shape != (tri9.shape[0], 12):
            raise ValueError("tri12: want (T, 12), pack_table(tri9, ids)")


def brute_nearest(tri9, ids, o, d, tmin, tmax, tri12=None):
    """Nearest hit of every ray against every row of the table.

    tri9 (T, 9) f32 `[v0 | e1 | e2]`, ids (T,) i32; o, d (N, 3), tmin,
    tmax (N,) f32; tri12: `pack_table(tri9, ids)`, if the caller keeps it
    (it is packed here otherwise).  Returns (t, prim, u, v), (N,) each."""
    _check(tri9, ids, o, d, tmin, tmax)
    _check_tri12(tri9, tri12, o.device)
    if o.device.type == "cpu":
        return brute_nearest_reference(tri9, ids, o, d, tmin, tmax)
    n = o.shape[0]
    t, u, v = (torch.empty_like(tmax) for _ in range(3))
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    if n:
        if tri12 is None:
            tri12 = pack_table(tri9, ids)
        _build.launch("brute", "spray_brute_nearest", o.device,
                      tri12.data_ptr(), tri9.shape[0],
                      o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
                      tmax.data_ptr(), n, t.data_ptr(), prim.data_ptr(),
                      u.data_ptr(), v.data_ptr())
        launches["brute_nearest_kernel"] += 1
    return t, prim, u, v


def brute_anyhit(tri9, ids, o, d, tmin, tmax, tri12=None, counter=None):
    """Occlusion of every ray in (tmin, tmax) against every row of the
    table; same arguments as `brute_nearest`; returns occ (N,) i32.
    counter: optional (1,) int64 CUDA tensor that receives the
    ray-triangle tests begun (a ray stops at its first hit)."""
    _check(tri9, ids, o, d, tmin, tmax)
    _check_tri12(tri9, tri12, o.device)
    if o.device.type == "cpu":
        return brute_anyhit_reference(tri9, ids, o, d, tmin, tmax)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.int32, device=o.device)
    if n:
        if tri12 is None:
            tri12 = pack_table(tri9, ids)
        _build.launch("brute", "spray_brute_anyhit", o.device,
                      tri12.data_ptr(), tri9.shape[0],
                      o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
                      tmax.data_ptr(), n, occ.data_ptr(),
                      _build.check_counter(counter, o.device))
        launches["brute_anyhit_kernel"] += 1
    return occ


def _tri_soa(v0, e1, e2):
    """(T, 9) f32 triangle table [v0 | e1 | e2] (host numpy)."""
    return np.ascontiguousarray(
        np.concatenate([v0, e1, e2], axis=1).astype(np.float32))


def brute_table(scene):
    """Host (tri9 (T, 9) f32, ids (T,) i32) of a scene, in face order."""
    verts = np.asarray(scene.vertices, np.float32)
    faces = np.asarray(scene.faces, np.int64)
    tv = verts[faces.reshape(-1)].reshape(-1, 3, 3)
    tri9 = _tri_soa(tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    return tri9, np.arange(len(tv), dtype=np.int32)


class PallasBruteIntersector:
    """Drop-in intersector over the CUDA brute kernels (the plain versions
    on the CPU).  It keeps the name of its counterpart
    ``spray_tpu.kernels.brute.PallasBruteIntersector`` so the two are found
    together; nothing here is Pallas."""

    def __init__(self, scene, device=None):
        self._init(*brute_table(scene), resolve_device(device))

    @classmethod
    def from_arrays(cls, tri9, ids, device=None):
        """Intersector over a table built elsewhere (numpy arrays)."""
        obj = cls.__new__(cls)
        obj._init(tri9, ids, resolve_device(device))
        return obj

    def _init(self, tri9, ids, device):
        self.device = device
        self.tri9 = torch.as_tensor(np.ascontiguousarray(tri9, np.float32),
                                    device=device)
        self.ids = torch.as_tensor(np.ascontiguousarray(ids, np.int32),
                                   device=device)
        self.tri12 = pack_table(self.tri9, self.ids)  # the kernels' table

    def intersect(self, o, d, tmin, tmax):
        t, prim, u, v = brute_nearest(
            self.tri9, self.ids, o.contiguous(), d.contiguous(),
            tmin.contiguous(), tmax.contiguous(), tri12=self.tri12)
        valid = prim >= 0
        return Hits(t=torch.where(valid, t, tmax), prim=prim, u=u, v=v,
                    valid=valid)

    def occluded(self, o, d, tmax):
        return brute_anyhit(
            self.tri9, self.ids, o.contiguous(), d.contiguous(),
            torch.zeros_like(tmax), tmax.contiguous(), tri12=self.tri12) != 0
