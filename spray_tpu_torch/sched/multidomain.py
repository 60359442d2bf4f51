"""The domain set's AABB view and the dense entry distances of the epoch
scheduler (counterpart of the first half of ``spray_tpu/sched/multidomain.py``).

The out-of-core cluster backend keeps only the domain boxes resident; each
domain's pages stream through the residency slots.  The reference's vmapped
jnp-BVH `trace_domain` and its `MultiDomainIntersector` belong to the jnp
backend, which the port does not carry yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import geom


@dataclasses.dataclass(frozen=True)
class DeviceDomainSet:
    """Domain AABBs on the device: aabb_lo, aabb_hi (D, 3) f32."""

    aabb_lo: torch.Tensor
    aabb_hi: torch.Tensor

    @property
    def num_domains(self):
        return self.aabb_lo.shape[0]


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
