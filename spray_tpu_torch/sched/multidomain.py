"""Single-device multi-domain tracing over per-domain BVHs, and the dense
entry distances of the epoch scheduler (counterpart of
``spray_tpu/sched/multidomain.py``).

With every domain resident, tracing a wavefront against each domain in turn
and keeping the nearest hit is speculation with a trivially correct commit:
every closer domain has been processed once the loop ends.  The loop
carries best-t, so later domains are culled by the traversal's
[tmin, best_t) window.

The two epoch engines, the out-of-core scheduler (`sched/epochs.py`) and
the in-situ collective epochs (`dist/epochs.py`), build on
`domain_entries` and take their shared decisions from here: which rays
still need which domain (`needed`, SpRay's commit rule), which needed
domain is a ray's nearest (`nearest_needed`), and how a padded wavefront
is traced against one resident cluster page (`PageWave`).  Their cluster
backends keep only the domain boxes of `DeviceDomainSet` resident.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bvh.traverse import DeviceBVH, traverse
from ..core import geom
from ..core.device import resolve_device
from ..core.types import Hits
from ..kernels import traverse as kernels
from ..kernels.common import pad_rays

BVH_FIELDS = ("child_lo", "child_hi", "child_node", "child_count", "v0", "e1",
              "e2", "orig_id")


@dataclasses.dataclass(frozen=True)
class DeviceDomainSet:
    """A DomainSet on the device: aabb_lo, aabb_hi (D, 3) f32 and the
    stacked (D, ...) BVH fields, which are None in the AABB-only view the
    cluster backend builds."""

    aabb_lo: torch.Tensor
    aabb_hi: torch.Tensor
    child_lo: torch.Tensor = None
    child_hi: torch.Tensor = None
    child_node: torch.Tensor = None
    child_count: torch.Tensor = None
    v0: torch.Tensor = None
    e1: torch.Tensor = None
    e2: torch.Tensor = None
    orig_id: torch.Tensor = None
    leaf_size: int = 0

    @classmethod
    def from_host(cls, ds, device=None):
        """The host DomainSet `ds` (numpy) on `device`."""
        device = resolve_device(device)
        return cls(**{k: torch.as_tensor(getattr(ds, k), device=device)
                      for k in ("aabb_lo", "aabb_hi") + BVH_FIELDS},
                   leaf_size=ds.leaf_size)

    @property
    def num_domains(self):
        return self.aabb_lo.shape[0]

    def domain_bvh(self, arrays):
        """A DeviceBVH view of one domain's arrays (a dict of BVH_FIELDS)."""
        return domain_bvh(arrays, self.leaf_size)

    def stacked(self):
        return {k: getattr(self, k) for k in BVH_FIELDS}


def domain_bvh(arrays, leaf_size):
    """A DeviceBVH view of one domain's arrays (a dict holding BVH_FIELDS)."""
    return DeviceBVH(**{k: arrays[k] for k in BVH_FIELDS}, leaf_size=leaf_size)


def domain_entries(dset, o, d, tmin, tmax):
    """(N, D) entry-t of each ray into each domain AABB (+inf if no overlap):
    the reference's 'domains_along(ray)' in dense form, entry order =
    ascending entry_t."""
    inv_d = 1.0 / torch.where(torch.abs(d) > 1e-12, d,
                              torch.full_like(d, 1e-12))
    ro_inv = o * inv_d
    t_entry, hit = geom.ray_aabb(
        ro_inv[:, None, :], inv_d[:, None, :], dset.aabb_lo[None],
        dset.aabb_hi[None], tmin[:, None], tmax[:, None],
    )
    return torch.where(hit, t_entry, torch.full_like(t_entry, geom.INF))


def trace_domain(dbvh, o, d, tmin, tmax, any_hit=False):
    """Traversal of one domain for a wavefront: (t, prim, u, v, found).
    tmax acts as the cull window (pass the current best-t)."""
    return traverse(dbvh, o, d, tmin, tmax, any_hit)


def needed(entry_t, processed, best_t, found, occ_mode):
    """(N, D) ray-needs-domain mask, SpRay's commit rule: a ray needs every
    overlapped, unprocessed domain it enters before its best t; an
    occlusion ray (occ_mode) needs none once it is found."""
    need = torch.isfinite(entry_t) & ~processed & (entry_t < best_t[:, None])
    return need & ~found[:, None] if occ_mode else need


def nearest_needed(need, entry_t):
    """(nearest needed domain, whether there is one) per ray, plus the
    masked entries (+inf where not needed); ties go to the lowest domain
    id."""
    masked = torch.where(need, entry_t, np.inf)
    mn, nearest = masked.min(dim=1)
    return nearest, torch.isfinite(mn), masked


class PageWave:
    """A wavefront padded once to whole packets and traced against one
    resident cluster page at a time; each trace rewrites only the window
    buffer.  A packet with no live window is dead (`live_buckets`)."""

    def __init__(self, o, d, tmin, window):
        self.n = o.shape[0]
        self.o, self.d, self.tmin, win = pad_rays(o, d, tmin, window,
                                                  kernels.PACKET)
        self.win = torch.zeros_like(win)

    def trace(self, page, live, best_t, any_hit, depth):
        """One launch over the page {bounds, meta, w, tri_ids (global ids)}
        with each ray's window best_t, or 0 where `live` (None: every ray)
        is false: the any-hit kernel on a one-entry list (any_hit), or the
        slot kernel.  Returns occluded (N,) bool, or (t, global prim) with
        prim -1 where the page has no hit."""
        n = self.n
        self.win[:n] = best_t if live is None else torch.where(live, best_t,
                                                               0.0)
        bucket = kernels.live_buckets(self.win.view(-1, kernels.PACKET))
        pages = (page["bounds"][None], page["meta"][None], page["w"][None])
        # the wrappers are looked up on their module at each call, so that a
        # recorder installed there (chip_smoke.py's SlotRecorder) sees them
        if any_hit:
            occ = kernels.anyhit(bucket[:, None].contiguous(), self.o, self.d,
                                 self.tmin, self.win, *pages, kernels.PACKET,
                                 depth)
            return occ[:n] != 0
        t, code = kernels.nearest_slot(bucket, self.o, self.d, self.tmin,
                                       self.win, *pages, kernels.PACKET, depth)
        t, code = t[:n], code[:n]
        prim = torch.where(code >= 0,
                           page["tri_ids"][torch.clamp(code, min=0).long()], -1)
        return t, prim.to(torch.int32)


class MultiDomainIntersector:
    """Drop-in intersector over a DeviceDomainSet (all domains resident): a
    loop over the domains carrying the running nearest hit.  Equivalent to
    the single-BVH intersector on the merged scene."""

    def __init__(self, scene=None, n_domains=8, dset=None, leaf_size=16,
                 branching=8, device=None):
        if dset is None:
            from ..domains.partition import partition_scene  # noqa: PLC0415

            dset = partition_scene(scene, n_domains, leaf_size=leaf_size,
                                   branching=branching)
        self.host_dset = dset
        self.dset = DeviceDomainSet.from_host(dset, device)

    def _domains(self):
        stacked = self.dset.stacked()
        for k in range(self.dset.num_domains):
            yield self.dset.domain_bvh({f: a[k] for f, a in stacked.items()})

    def intersect(self, o, d, tmin, tmax):
        n, dev = o.shape[0], o.device
        bt, found = tmax, torch.zeros(n, dtype=torch.bool, device=dev)
        bp = torch.full((n,), -1, dtype=torch.int32, device=dev)
        bu, bv = torch.zeros_like(tmax), torch.zeros_like(tmax)
        for dbvh in self._domains():
            t, p, u, v, f = trace_domain(dbvh, o, d, tmin, bt)
            upd = f & (t < bt)
            bt = torch.where(upd, t, bt)
            bp = torch.where(upd, p, bp)
            bu = torch.where(upd, u, bu)
            bv = torch.where(upd, v, bv)
            found = found | f
        return Hits(t=torch.where(found, bt, tmax), prim=bp, u=bu, v=bv,
                    valid=found)

    def occluded(self, o, d, tmax):
        tmin = torch.zeros_like(tmax)
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for dbvh in self._domains():
            # occluded rays get an empty window and are not walked
            win = torch.where(occ, torch.zeros_like(tmax), tmax)
            occ = occ | trace_domain(dbvh, o, d, tmin, win, any_hit=True)[4]
        return occ
