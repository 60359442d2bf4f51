"""Sorted visit-sweep tracer over the binned visit kernels.

Counterpart of ``spray_tpu/kernels/sweep.py``.  Same foundations as the
binned cascade (`kernels/binned.py`: the visit kernels, the frustum cull,
the coherence sort), different orchestration: the intervals, the (P, S)
entries and their front-to-back sort are computed ONCE per trace call; each
packet keeps a CURSOR into its own sorted supernode list; a loop runs visit
CHUNKS of at most v_cap visits, packed packet-major from exactly the visits
still owed (searchsorted over the cumulative counts, no scatter, no
re-sort), re-culled between chunks with each packet's tightened upper
bound.  The first chunk visits only the band0 nearest supernodes per
packet, so best t collapses before the main sweep.

Commit-invariant safety: a supernode is skipped forever only when its
conservative packet entry >= the packet's max best t at skip time; entries
only lower-bound per-ray entries and best t never increases, so a skipped
supernode can never beat a committed hit.

The reference's chunk loop is a ``lax.while_loop``; the port's runs on the
host and reads the number of visits still owed once per chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from .binned import (
    BP,
    BinnedIntersector,
    BinnedScene,
    INF,
    anyhit_visits,
    cluster_masks,
    nearest_visits,
    packet_intervals,
    supernode_entries,
)
from ..core.device import resolve_device


def _chunk_assemble(counts, cursor, order, ent_sorted, v_cap, s_null):
    """Pack the next <= v_cap live visits into flat arrays, packet-major.

    counts: (P,) visits each packet still owes (already upper-culled);
    cursor: (P,) columns of `order` consumed so far.  Returns
    (pkt, sn, ent, first, last, taken) where taken (P,) is how many visits
    of each packet this chunk contains.  No scatter: slot -> packet is a
    searchsorted over the cumsum, slot -> column is cursor + local rank.
    """
    p = counts.shape[0]
    cum = counts.cumsum(0)  # (P,) int64
    total = cum[-1]
    slots = torch.arange(v_cap, device=counts.device)
    valid = slots < torch.clamp(total, max=v_cap)
    # clamp into the last valid slot so the padded tail extends the final
    # packet's run with null visits (no run of its own)
    slot_c = torch.minimum(slots, torch.clamp(total - 1, min=0))
    pkt = torch.searchsorted(cum, slot_c, right=True)
    pkt = torch.clamp(pkt, max=p - 1)
    base = cum[pkt] - counts[pkt]  # global slot where this packet's run starts
    col = cursor[pkt] + (slot_c - base)
    col = torch.clamp(col, 0, order.shape[1] - 1)
    sn = torch.where(valid, order[pkt, col], s_null)
    ent = torch.where(valid, ent_sorted[pkt, col], INF)
    prev = torch.cat([pkt[:1] - 1, pkt[:-1]])
    nxt = torch.cat([pkt[1:], pkt[-1:] + 1])
    first = (pkt != prev).to(torch.int32)
    last = (pkt != nxt).to(torch.int32)
    taken = torch.minimum(
        torch.clamp(torch.clamp(cum, max=v_cap) - (cum - counts), min=0),
        counts)
    return pkt.to(torch.int32), sn.to(torch.int32), ent, first, last, taken


def _visit_masks(ivals, cbox, pkt, sn, upper):
    """Per-visit cluster bitmasks: rows of `cluster_masks` must align with
    the frustum intervals, so gather the visit's packet intervals first."""
    pkt = pkt.long()
    ivals_v = {k: v[pkt] for k, v in ivals.items()}
    return cluster_masks(ivals_v, cbox, sn[:, None], upper[pkt])[:, 0]


def _avail_counts(ent_sorted, cursor, upper):
    """(P,) visits with entry below the packet's upper bound, cursor-adjusted.

    ent_sorted rows are ascending, so the count of useful columns is a
    compare and a sum; columns already consumed never recount.
    """
    below = (ent_sorted < upper[:, None]).sum(dim=1)
    return torch.clamp(below - cursor, min=0)


class _Sweep:
    """The per-call constants of a sweep and its chunk loop."""

    def __init__(self, scene_arrays, o, d, tmin, tmax_eff, band0, v_cap,
                 stats):
        self.tri9, self.cbox, sbox = scene_arrays
        self.s_null = self.tri9.shape[0] - 1
        self.o, self.d, self.tmin = o, d, tmin
        self.band0, self.v_cap, self.stats = band0, v_cap, stats
        self.ivals = packet_intervals(o, d, tmin, tmax_eff)
        entry = supernode_entries(self.ivals, sbox)  # (P, S)
        self.order = torch.argsort(entry, dim=1, stable=True)
        self.ent_sorted = torch.gather(entry, 1, self.order)

    def chunk(self, counts, cursor, upper):
        """The next chunk's visit list and how many visits of each packet
        it takes."""
        pkt, sn, _, first, last, taken = _chunk_assemble(
            counts, cursor, self.order, self.ent_sorted, self.v_cap,
            self.s_null)
        cmask = torch.where(
            sn != self.s_null,
            _visit_masks(self.ivals, self.cbox, pkt, sn, upper), 0)
        self.stats["rounds"] += 1
        self.stats["visits"] += self.v_cap
        return (pkt, sn, cmask, first, last), taken

    def run(self, carry, upper_of, visit):
        """Iteration 0 visits the nearest band only (a cheap best-t
        collapse); then chunks run until no packet owes a visit.  Each
        later chunk reads the owed total from the device."""
        cursor = torch.zeros_like(self.order[:, 0])
        counts = torch.clamp(
            _avail_counts(self.ent_sorted, cursor, upper_of(carry)),
            max=self.band0)
        while True:
            vlist, taken = self.chunk(counts, cursor, upper_of(carry))
            # packets outside the chunk keep their values: the wrappers
            # return updated copies, not freshly written blocks
            carry = visit(carry, vlist)
            cursor = cursor + taken
            counts = _avail_counts(self.ent_sorted, cursor, upper_of(carry))
            self.stats["syncs"] += 1
            if int(counts.sum()) == 0:
                return carry


def _sweep_nearest(scene_arrays, o, d, tmin, tmax_eff, band0, v_cap, stats):
    """Flat in, flat out (input ray order); len(o) % BP == 0."""
    sw = _Sweep(scene_arrays, o, d, tmin, tmax_eff, band0, v_cap, stats)
    p = o.shape[0] // BP
    carry = (tmax_eff.contiguous(),
             torch.full((p * BP,), -1, dtype=torch.int32, device=o.device))
    return sw.run(
        carry,
        lambda c: c[0].view(p, BP).amax(dim=1),
        lambda c, vlist: nearest_visits(*vlist, o, d, tmin, sw.tri9, *c))


def _sweep_anyhit(scene_arrays, o, d, tmin, tmax_eff, band0, v_cap, stats):
    sw = _Sweep(scene_arrays, o, d, tmin, tmax_eff, band0, v_cap, stats)
    p = o.shape[0] // BP
    win = tmax_eff.view(p, BP)
    occ = torch.zeros(p * BP, dtype=torch.int32, device=o.device)
    return sw.run(
        occ,
        lambda c: torch.where(c.view(p, BP) != 0, 0.0, win).amax(dim=1),
        lambda c, vlist: anyhit_visits(*vlist, o, d, tmin, tmax_eff, sw.tri9,
                                       c))


class SweepIntersector(BinnedIntersector):
    """Drop-in intersector over the sorted visit sweep.

    band0: supernodes visited per packet in the collapse iteration.
    v_cap_per_pkt: chunk capacity as a multiple of the packet count (the
    chunk holds at most 65,536 visits).
    Inherits the window clamp, padding and coherence sort from
    BinnedIntersector; only the trace core differs.
    """

    def __init__(self, scene, band0=8, v_cap_per_pkt=8, sort=True,
                 device=None):
        device = resolve_device(device)
        b = BinnedScene(np.asarray(scene.vertices), np.asarray(scene.faces))
        self._init(scene, b.arrays(), device, band0=band0,
                   v_cap_per_pkt=v_cap_per_pkt, sort=sort)

    def _init(self, scene, arrays, device, band0=8, v_cap_per_pkt=8,
              sort=True):
        super()._init(scene, arrays, device, sort=sort)
        self.band0 = band0
        self.v_cap_per_pkt = v_cap_per_pkt

    def _v_cap(self, o_):
        return int(min(self.v_cap_per_pkt * (o_.shape[0] // BP), 1 << 16))

    def _run_nearest(self, o_, d_, tmin_, tmax_):
        return _sweep_nearest((self.tri9, self.cbox, self.sbox), o_, d_,
                              tmin_, tmax_, self.band0, self._v_cap(o_),
                              self.stats)

    def _run_anyhit(self, o_, d_, tmin_, tmax_):
        return _sweep_anyhit((self.tri9, self.cbox, self.sbox), o_, d_,
                             tmin_, tmax_, self.band0, self._v_cap(o_),
                             self.stats)
