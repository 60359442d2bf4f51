"""Brute-force O(rays x tris) intersector in torch — the correctness oracle
of the port (counterpart of ``spray_tpu/oracle/brute.py``).

Nearest-hit ties break to the LOWEST triangle index: `torch.argmin` returns
the first minimum, as numpy and XLA do.  Rays are processed in chunks so the
(rays, tris) working set stays bounded.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import geom
from ..core.device import resolve_device
from ..core.types import Hits


class BruteIntersector:
    """Intersects against one triangle soup; precomputes v0/e1/e2."""

    def __init__(self, scene, device=None, budget=1 << 24):
        device = resolve_device(device)
        verts = np.asarray(scene.vertices, np.float32)
        faces = np.asarray(scene.faces, np.int64)
        tv = verts[faces.reshape(-1)].reshape(-1, 3, 3)
        self.v0 = torch.as_tensor(np.ascontiguousarray(tv[:, 0]), device=device)
        self.e1 = torch.as_tensor(tv[:, 1] - tv[:, 0], device=device)
        self.e2 = torch.as_tensor(tv[:, 2] - tv[:, 0], device=device)
        self.chunk = max(1, budget // max(1, len(tv)))

    def _mt(self, o, d):
        return geom.moller_trumbore(
            o[:, None, :], d[:, None, :], self.v0[None], self.e1[None],
            self.e2[None],
        )

    def intersect(self, o, d, tmin, tmax):
        """Nearest hit.  o, d: (N, 3); tmin/tmax: (N,).  Returns Hits."""
        parts = []
        for s in range(0, o.shape[0], self.chunk):
            sl = slice(s, s + self.chunk)
            t, u, v, ok = self._mt(o[sl], d[sl])
            inside = ok & (t >= tmin[sl, None]) & (t <= tmax[sl, None])
            t = torch.where(inside, t, torch.full_like(t, geom.INF))
            prim = torch.argmin(t, dim=1, keepdim=True)  # first on ties
            tbest = torch.gather(t, 1, prim)[:, 0]
            valid = torch.isfinite(tbest)
            parts.append((
                torch.where(valid, tbest, tmax[sl]),
                torch.where(valid, prim[:, 0].to(torch.int32), -1),
                torch.gather(u, 1, prim)[:, 0],
                torch.gather(v, 1, prim)[:, 0],
                valid,
            ))
        return Hits(*(torch.cat(x) for x in zip(*parts)))

    def occluded(self, o, d, tmax):
        """Any hit within (0, tmax).  Returns (N,) bool."""
        out = []
        for s in range(0, o.shape[0], self.chunk):
            sl = slice(s, s + self.chunk)
            t, _, _, ok = self._mt(o[sl], d[sl])
            out.append((ok & (t > 0.0) & (t < tmax[sl, None])).any(dim=1))
        return torch.cat(out)
