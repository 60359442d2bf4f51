"""Epoch-based speculative ray scheduler (counterpart of
``spray_tpu/sched/epochs.py``).

Per epoch: count each domain's ray queue, schedule the K largest queues,
make their pages resident, trace speculatively, and commit hits whose every
closer domain has been processed.  As in the reference:

  - queues are not materialized: a ray is in queue[d] when
        needed(i, d) = overlaps(i, d) & ~processed(i, d) & entry_t(i, d) < best_t(i);
  - the schedule is the top K domains by queue count (K = resident slots);
  - SPECULATIVE: every scheduled domain traces all rays that need it;
    BASELINE (speculate=False): a ray is traced only in its nearest
    unprocessed domain; BOUNDED (speculate=k): in its k nearest;
  - commit is implicit: a ray is done when `needed` is empty, and its best
    (t, prim) then satisfies the commit invariant.

Two backends, as in the reference.  The cluster backend: each slot's
trace is one launch of the CUDA `nearest_slot` kernel (or of `anyhit` with
a one-entry domain list for occlusion rays) on the slot's cluster pages;
the reference's device-side `lax.while_loop` over epochs becomes a Python
loop over device tensors that reads its `more_work` flag once per epoch:
one host sync per epoch, where the reference pays none.  The jnp backend
(the reference's name, kept so that the two APIs match): each slot's
trace walks the domain's BVH (`bvh/traverse.py`, a `partition_scene`
domain set), with the host-driven per-epoch loop (`epoch_step`).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from .. import trace
from ..bvh.traverse import DeviceBVH
from ..core.device import resolve_device
from ..core.types import Hits
from ..kernels import traverse
from ..kernels.common import pad_rays
from ..kernels.traverse import PACKET
from ..kernels.multidomain import _live_partition, build_cluster_domains
from ..residency.manager import ResidencyManager
from .multidomain import BVH_FIELDS, DeviceDomainSet, domain_entries, trace_domain

PROBE_MB_S = 50.0  # host->device rate below which lookahead turns itself off
EPOCH_LOG_ROWS = 4096  # rows of `epoch_log` kept: the newest batches


@dataclasses.dataclass
class EpochState:
    """Wavefront trace state carried across epochs."""

    o: torch.Tensor
    d: torch.Tensor
    tmin: torch.Tensor
    best_t: torch.Tensor  # (N,) current nearest (the ray's tmax while no hit)
    best_prim: torch.Tensor  # (N,) global tri id or -1
    best_u: torch.Tensor  # (N,) barycentrics of the best hit (jnp backend)
    best_v: torch.Tensor
    found: torch.Tensor  # (N,) bool
    entry_t: torch.Tensor  # (N, D) domain entry distance (+inf no overlap)
    processed: torch.Tensor  # (N, D) bool
    occ_mode: bool  # any-hit semantics (occlusion rays)


@dataclasses.dataclass
class EpochStats:
    """Per-run work counters of the reference."""

    epochs: int = 0
    rays_traced: int = 0  # ray-domain trace activations
    rays_speculated: int = 0  # activations beyond the nearest-domain minimum
    committed: int = 0
    domain_loads: int = 0
    cache_hits: int = 0
    prefetches: int = 0  # lookahead uploads overlapped with tracing

    @property
    def speculation_efficiency(self):
        """committed / traced: the metric of the core idea."""
        return self.committed / max(self.rays_traced, 1)


def init_state(dset, o, d, tmin, tmax, occ_mode=False):
    entry = domain_entries(dset, o, d, tmin, tmax)
    n = o.shape[0]
    return EpochState(
        o=o, d=d, tmin=tmin, best_t=tmax,
        best_prim=torch.full((n,), -1, dtype=torch.int32, device=o.device),
        best_u=torch.zeros_like(tmax), best_v=torch.zeros_like(tmax),
        found=torch.zeros(n, dtype=torch.bool, device=o.device),
        entry_t=entry, processed=torch.zeros_like(entry, dtype=torch.bool),
        occ_mode=bool(occ_mode),
    )


def _needed(entry_t, processed, best_t, found, occ_mode):
    need = torch.isfinite(entry_t) & ~processed & (entry_t < best_t[:, None])
    return need & ~found[:, None] if occ_mode else need


def needed_mask(state):
    """(N, D) ray-needs-domain mask == implicit queue membership."""
    return _needed(state.entry_t, state.processed, state.best_t, state.found,
                   state.occ_mode)


def _nearest_needed(need, entry_t):
    """(nearest needed domain, whether there is one) per ray, plus the
    masked entries; ties go to the lowest domain id."""
    masked = torch.where(need, entry_t, torch.full_like(entry_t, np.inf))
    mn, nearest = masked.min(dim=1)
    return nearest, torch.isfinite(mn), masked


def queue_counts(state):
    """(D,) queue sizes: each ray is queued for its nearest unprocessed
    overlapped domain only (the reference's allgathered counts)."""
    nearest, has, _ = _nearest_needed(needed_mask(state), state.entry_t)
    return torch.bincount(nearest[has], minlength=state.entry_t.shape[1])


def second_queue_counts(state):
    """(D,) counts of each ray's second-nearest needed domain: where it goes
    once its nearest is traced, unless it commits first (the prefetch
    predictor)."""
    nearest, _, masked = _nearest_needed(needed_mask(state), state.entry_t)
    masked2 = masked.scatter(1, nearest[:, None], np.inf)
    mn2, second = masked2.min(dim=1)
    return torch.bincount(second[torch.isfinite(mn2)],
                          minlength=state.entry_t.shape[1])


def schedule_top_k(counts, k):
    """The K largest nonempty queues (biggest-queue-first)."""
    order = np.argsort(-counts, kind="stable")
    return [int(d) for d in order[:k] if counts[d] > 0]


class _Wave:
    """A wavefront padded once to whole packets; each slot trace rewrites
    only the window."""

    def __init__(self, state):
        self.n = state.o.shape[0]
        self.o, self.d, self.tmin, win = pad_rays(
            state.o, state.d, state.tmin, state.best_t, PACKET)
        self.win = torch.zeros_like(win)

    def trace(self, slot, live, best_t, any_hit, depth):
        """One slot launch over the rays with `live` windows.  Returns
        occluded (N,) bool for any_hit, else (t, prim) with prim -1 where
        the slot has no hit."""
        n = self.n
        self.win[:n] = torch.where(live, best_t, torch.zeros_like(best_t))
        bucket = traverse.live_buckets(self.win.view(-1, PACKET))
        pages = (slot["bounds"][None], slot["meta"][None], slot["w"][None])
        if any_hit:
            occ = traverse.anyhit(bucket[:, None].contiguous(), self.o,
                                  self.d, self.tmin, self.win, *pages,
                                  PACKET, depth)
            return occ[:n] != 0
        t, code = traverse.nearest_slot(bucket, self.o, self.d, self.tmin,
                                        self.win, *pages, PACKET, depth)
        t, code = t[:n], code[:n]
        prim = torch.where(code >= 0,
                           slot["tri_ids"][torch.clamp(code, min=0).long()], -1)
        return t, prim.to(torch.int32)


def _trace_slots(state, wave, slots, need, nearest, has_need, speculate,
                 any_hit, depth, carry):
    """Trace every (domain id, pages) slot once.  carry = (best_t,
    best_prim, found, processed, traced, spec) device tensors; returns the
    updated carry."""
    best_t, best_prim, found, processed, traced, spec = carry
    for d_id, slot in slots:
        with trace.span("spray.sched.slot"):
            at_nearest = (nearest == d_id) & has_need
            active = need[:, d_id]
            if not speculate:
                active = active & at_nearest
            traced = traced + active.sum()
            spec = spec + (active & ~at_nearest).sum()
            live = active & ~found if state.occ_mode else active
            if any_hit:
                f = wave.trace(slot, live, best_t, True, depth) & active
            else:
                t, prim = wave.trace(slot, live, best_t, False, depth)
                f = (prim >= 0) & active
                upd = f & (t < best_t)
                best_t = torch.where(upd, t, best_t)
                best_prim = torch.where(upd, prim, best_prim)
            found = found | f
            processed[:, d_id] |= active
    return best_t, best_prim, found, processed, traced, spec


def _zero_counts(state):
    z = torch.zeros((), dtype=torch.int64, device=state.o.device)
    return z, z


def epoch_step(state, slots, speculate, leaf_size):
    """Trace one epoch over the resident slots [(domain id, BVH pages), ...]
    by walking each domain's BVH (the jnp backend).  Occlusion rays take the
    nearest walk too, as in the reference.  Returns (state, traced,
    speculated) with the counts as device tensors."""
    need = needed_mask(state)
    nearest, has_need, _ = _nearest_needed(need, state.entry_t)
    traced, spec = _zero_counts(state)
    bt, bp, bu, bv, found = (state.best_t, state.best_prim, state.best_u,
                             state.best_v, state.found)
    processed = state.processed.clone()
    for d_id, slot in slots:
        at_nearest = (nearest == d_id) & has_need
        active = need[:, d_id]
        if not speculate:
            active = active & at_nearest
        traced = traced + active.sum()
        spec = spec + (active & ~at_nearest).sum()
        dbvh = DeviceBVH(**{k: slot[k] for k in BVH_FIELDS}, leaf_size=leaf_size)
        window = torch.where(active, bt, torch.zeros_like(bt))
        t, p, u, v, f = trace_domain(dbvh, state.o, state.d, state.tmin, window)
        upd = f & (t < bt) & active
        bt = torch.where(upd, t, bt)
        bp = torch.where(upd, p, bp)
        bu = torch.where(upd, u, bu)
        bv = torch.where(upd, v, bv)
        found = found | (f & active)
        processed[:, d_id] |= active
    state = dataclasses.replace(state, best_t=bt, best_prim=bp, best_u=bu,
                                best_v=bv, found=found, processed=processed)
    return state, traced, spec


def epoch_step_cluster(state, slots, speculate, depth):
    """Trace one epoch over the resident slots [(domain id, pages), ...]
    with the CUDA slot kernel.  Occlusion rays use the nearest kernel with
    zero windows on found lanes, as the reference's epoch step does.
    Returns (state, traced, speculated) with the counts as device tensors."""
    need = needed_mask(state)
    nearest, has_need, _ = _nearest_needed(need, state.entry_t)
    wave = _Wave(state)
    carry = (state.best_t, state.best_prim, state.found,
             state.processed.clone(), *_zero_counts(state))
    bt, bp, found, processed, traced, spec = _trace_slots(
        state, wave, slots, need, nearest, has_need, speculate, False, depth,
        carry)
    state = dataclasses.replace(state, best_t=bt, best_prim=bp, found=found,
                                processed=processed)
    return state, traced, spec


def epoch_batch_cluster(state, slots, speculate, max_epochs, depth,
                        any_hit=False, spec_bound=None):
    """Run epochs until no ray needs a RESIDENT domain (or max_epochs).

    slots: [(domain id, pages), ...].  any_hit=True runs the any-hit kernel
    (occlusion wavefronts).  spec_bound=k (with speculate) traces only each
    ray's k nearest needed domains per epoch.  Reads one flag per epoch.
    Returns (state, epochs, traced, speculated, remaining): epochs an int,
    the counts device tensors, remaining whether resident work is left
    (epochs == max_epochs alone is not a failure)."""
    n_dom = state.entry_t.shape[1]
    resident = torch.zeros(n_dom, dtype=torch.bool, device=state.o.device)
    resident[[d for d, _ in slots]] = True
    wave = _Wave(state)

    def derive(best_t, found, processed):
        need = _needed(state.entry_t, processed, best_t, found, state.occ_mode)
        if spec_bound is not None and speculate:
            ent = torch.where(need, state.entry_t,
                              torch.full_like(state.entry_t, np.inf))
            k = min(spec_bound, n_dom) - 1
            thr = torch.sort(ent, dim=1).values[:, k]
            need = need & (state.entry_t <= thr[:, None])
        nearest, has_need, _ = _nearest_needed(need, state.entry_t)
        if speculate:
            more = (need & resident[None, :]).any()
        else:
            more = (has_need & resident[nearest]).any()
        return need, nearest, has_need, more

    carry = (state.best_t, state.best_prim, state.found,
             state.processed.clone(), *_zero_counts(state))
    epochs = 0
    while True:
        need, nearest, has_need, more = derive(carry[0], carry[2], carry[3])
        with trace.sync("more"):
            more = bool(more)
        if epochs >= max_epochs or not more:
            break
        carry = _trace_slots(state, wave, slots, need, nearest, has_need,
                             speculate, any_hit, depth, carry)
        epochs += 1
    bt, bp, found, processed, traced, spec = carry
    state = dataclasses.replace(state, best_t=bt, best_prim=bp, found=found,
                                processed=processed)
    return state, epochs, traced, spec, more


class OOCIntersector:
    """Out-of-core multi-domain intersector (the reference's config 4).

    Same interface as every other intersector; internally runs the epoch
    loop with at most `num_slots` domains resident at a time.  Host-driven:
    scheduling and residency run on the host between launches, so the
    integrator drives it from its eager wavefront loop.  backend "cluster"
    traces cluster pages with the CUDA kernels, "jnp" walks the BVHs of a
    domain set (`dset`, or `partition_scene` of the scene); "auto" is the
    cluster backend on the card unless a `dset` is given, else "jnp"."""

    host_driven = True

    def __init__(self, scene=None, n_domains=64, num_slots=8, dset=None,
                 leaf_size=16, branching=8, speculate=True, max_epochs=256,
                 lookahead=True, backend="auto", device_batched=None,
                 pages=None, device=None):
        device = resolve_device(device)
        if backend == "auto":  # the card is the port's analog of the TPU
            backend = ("cluster" if dset is None and device.type == "cuda"
                       else "jnp")
        if backend not in ("cluster", "jnp"):
            raise ValueError(f"backend: want 'auto', 'cluster' or 'jnp', got "
                             f"{backend!r}")
        self.device = device
        self.backend = backend
        # the cluster backend runs epochs in batches between residency
        # changes; device_batched=False keeps the host-driven per-epoch loop
        # (the tests' semantics oracle), the jnp backend's only loop
        self.device_batched = (backend == "cluster"
                               and (device_batched is None or device_batched))
        # speculate: False = strict front-to-back; True = unbounded; int
        # k >= 1 = bounded to each ray's k nearest needed domains per epoch
        self.spec_bound = (speculate if isinstance(speculate, int)
                           and not isinstance(speculate, bool) else None)
        self.speculate = bool(speculate)
        self.max_epochs = max_epochs
        if backend == "cluster":
            if pages is None:  # else the numpy dict of build_cluster_domains
                pages = build_cluster_domains(scene, n_domains)
            aabb = torch.as_tensor(pages["aabb"], device=device)
            self.dset = DeviceDomainSet(aabb_lo=aabb[:, 0:3].contiguous(),
                                        aabb_hi=aabb[:, 3:6].contiguous())
            self.depth = traverse.tree_depth(pages["meta"])
            self.v0, self.e1, self.e2 = traverse.tri_soa_from_scene(scene,
                                                                    device)
            host = {k: np.ascontiguousarray(pages[k], dt)
                    for k, dt in (("bounds", np.float32), ("meta", np.int32),
                                  ("w", np.float32), ("tri_ids", np.int64))}
        else:
            if dset is None:
                from ..domains.partition import partition_scene  # noqa: PLC0415

                dset = partition_scene(scene, n_domains, leaf_size=leaf_size,
                                       branching=branching)
            self.dset = DeviceDomainSet(
                aabb_lo=torch.as_tensor(dset.aabb_lo, device=device),
                aabb_hi=torch.as_tensor(dset.aabb_hi, device=device),
                leaf_size=dset.leaf_size)
            self.leaf_size = dset.leaf_size
            host = {k: getattr(dset, k) for k in BVH_FIELDS}
        self.host_dset = dset
        # host pages: pinned once on the card's host, sliced per domain
        host = {k: torch.as_tensor(v) for k, v in host.items()}
        if device.type == "cuda":
            host = {k: v.pin_memory() for k, v in host.items()}
        self._host_pages = host

        def provider(d):
            return {k: v[d] for k, v in host.items()}

        # Prefetch lookahead: predicted next-epoch domains upload into
        # `reserve` extra slots while the current batch traces.  It pays
        # only when an upload finishes well inside a batch: one timed 1 MB
        # upload decides, and below PROBE_MB_S lookahead turns itself off.
        self.lookahead = lookahead and num_slots >= 2
        self.host_to_hbm_mbps = None
        if self.lookahead:
            probe = np.zeros(1 << 18, np.float32)  # 1 MB
            t0 = time.perf_counter()
            buf = torch.as_tensor(probe).to(device)
            float(buf[:1].sum())  # fence the transfer
            dt = max(time.perf_counter() - t0, 1e-6)
            self.host_to_hbm_mbps = probe.nbytes / dt / 1e6
            if self.host_to_hbm_mbps < PROBE_MB_S:
                self.lookahead = False
        self.sched_width = num_slots
        self.reserve = max(1, num_slots // 4) if self.lookahead else 0
        self.residency = ResidencyManager(num_slots + self.reserve, provider,
                                          device)
        self.stats = EpochStats()
        # one dict per batch (or epoch): queue sizes, schedule, residency
        # and work counters; the newest EPOCH_LOG_ROWS, so that a
        # long-lived intersector holds a bounded log
        self.epoch_log = collections.deque(maxlen=EPOCH_LOG_ROWS)
        self._n_domains_actual = self.dset.num_domains
        # every domain fits the slots: the whole trace is one batch
        self.all_resident = (self.device_batched
                             and self._n_domains_actual <= self.sched_width)
        if self.all_resident:
            ids = list(range(self._n_domains_actual))
            self._slots_all = list(zip(ids, self.residency.acquire(ids)))

    def _absorb(self, epochs, traced, spec, entry):
        self.stats.epochs += epochs
        self.stats.rays_traced += traced
        self.stats.rays_speculated += spec
        self.epoch_log.append({
            **entry, "traced": traced, "speculated": spec,
            "loads": self.residency.loads, "hits": self.residency.hits,
            "prefetches": self.residency.prefetches,
        })

    def _sync_residency_stats(self):
        self.stats.domain_loads = self.residency.loads
        self.stats.cache_hits = self.residency.hits
        self.stats.prefetches = self.residency.prefetches

    def _schedule(self, counts, sched):
        """(domain id, pages) slots: the scheduled domains, plus, when
        speculating, resident domains with queued rays (free extra work)."""
        slots = list(zip(sched, self.residency.acquire(sched)))
        if self.speculate:
            for d in self.residency.resident_ids:
                if len(slots) >= self.sched_width:
                    break
                if d not in sched and counts[d] > 0:
                    slots.append((int(d), self.residency.peek(d)))
        return slots

    def _run_epochs_all_resident(self, state, any_hit):
        """All domains resident: the entire trace is one batch."""
        with trace.span("spray.sched.epochs"):
            state, epochs, traced, spec, remaining = epoch_batch_cluster(
                state, self._slots_all, self.speculate, self.max_epochs,
                self.depth, any_hit=any_hit, spec_bound=self.spec_bound)
        if remaining:
            raise RuntimeError("epoch loop failed to converge (max_epochs)")
        with trace.sync("traced"):
            traced, spec = torch.stack([traced, spec]).tolist()
        self._absorb(epochs, traced, spec, {
            "epoch": self.stats.epochs + epochs,
            "scheduled": list(range(self._n_domains_actual)),
            "batch_epochs": epochs,
        })
        self._sync_residency_stats()
        return state

    def _run_epochs_batched(self, state, any_hit=False):
        """One host round trip per residency change: read the queue counts,
        schedule and upload the top-K domains, prefetch the predicted next
        batch into the reserve, then run epochs until no resident domain
        has work."""
        k = self.sched_width
        for _ in range(self.max_epochs):
            with trace.span("spray.sched.batch"):
                with trace.span("spray.sched.counts"):
                    if self.lookahead:
                        both = torch.stack([queue_counts(state),
                                            second_queue_counts(state)])
                        with trace.sync("counts"):
                            both = both.cpu().numpy()
                        counts, counts_next = both[0], both[1]
                    else:
                        counts = queue_counts(state)
                        with trace.sync("counts"):
                            counts = counts.cpu().numpy()
                if counts.sum() == 0:
                    break
                sched = schedule_top_k(counts, k)
                slots = self._schedule(counts, sched)
                ids = [d for d, _ in slots]
                if self.lookahead:
                    # the next batch from each ray's second-nearest needed
                    # domain, then current-queue order
                    with trace.span("spray.sched.lookahead"):
                        order = np.argsort(-counts_next, kind="stable")
                        nxt = [int(d) for d in order
                               if counts_next[d] > 0 and int(d) not in ids]
                        nxt += [int(d)
                                for d in np.argsort(-counts, kind="stable")
                                if counts[d] > 0 and int(d) not in ids
                                and int(d) not in nxt]
                        self.residency.prefetch(nxt[:self.reserve],
                                                pinned=sched)
                with trace.span("spray.sched.epochs"):
                    state, epochs, traced, spec, _ = epoch_batch_cluster(
                        state, slots, self.speculate, self.max_epochs,
                        self.depth, any_hit=any_hit,
                        spec_bound=self.spec_bound)
                if epochs == 0:
                    raise RuntimeError(
                        "batched epoch loop made no progress (scheduled "
                        "domains had no resident work)")
                with trace.sync("traced"):
                    traced, spec = torch.stack([traced, spec]).tolist()
                with trace.span("spray.sched.absorb"):
                    self._absorb(epochs, traced, spec, {
                        "epoch": self.stats.epochs + epochs,
                        "queued": int(counts.sum()), "scheduled": sched,
                        "resident_extra": len(ids) - len(sched),
                        "batch_epochs": epochs,
                    })
        else:
            raise RuntimeError("epoch loop failed to converge (max_epochs)")
        self._sync_residency_stats()
        return state

    def _run_epochs(self, state, any_hit=False):
        if self.all_resident:
            return self._run_epochs_all_resident(state, any_hit)
        if self.device_batched:
            return self._run_epochs_batched(state, any_hit)
        for _ in range(self.max_epochs):
            with trace.span("spray.sched.batch"):
                with trace.span("spray.sched.counts"):
                    counts = queue_counts(state)
                    with trace.sync("counts"):
                        counts = counts.cpu().numpy()
                sched = schedule_top_k(counts, self.sched_width)
                if not sched:
                    break
                slots = self._schedule(counts, sched)
                if self.lookahead:
                    # the next epoch = next-biggest queues not resident now
                    with trace.span("spray.sched.lookahead"):
                        order = np.argsort(-counts, kind="stable")
                        ids = [d for d, _ in slots]
                        nxt = [int(d) for d in order
                               if counts[d] > 0 and int(d) not in ids]
                        self.residency.prefetch(nxt[:self.reserve],
                                                pinned=sched)
                with trace.span("spray.sched.epochs"):
                    if self.backend == "cluster":
                        state, traced, spec = epoch_step_cluster(
                            state, slots, self.speculate, self.depth)
                    else:
                        state, traced, spec = epoch_step(
                            state, slots, self.speculate, self.leaf_size)
                with trace.sync("traced"):
                    traced, spec = torch.stack([traced, spec]).tolist()
                with trace.span("spray.sched.absorb"):
                    self._absorb(1, traced, spec, {
                        "epoch": self.stats.epochs + 1,
                        "queued": int(counts.sum()), "scheduled": sched,
                        "resident_extra": len(slots) - len(sched),
                    })
        else:
            raise RuntimeError("epoch loop failed to converge (max_epochs)")
        self._sync_residency_stats()
        return state

    def _wavefront_perm(self, o, d, tmax):
        """The (octant, origin-cell) packet permutation of the multi-domain
        intersector; results are permutation-exact."""
        return _live_partition(tmax, d, o, self.dset.aabb_lo.amin(dim=0),
                               self.dset.aabb_hi.amax(dim=0))

    def intersect(self, o, d, tmin, tmax):
        with trace.span("spray.glue.partition"):
            perm, inv = self._wavefront_perm(o, d, tmax)
            state = init_state(self.dset, o[perm], d[perm], tmin[perm],
                               tmax[perm], occ_mode=False)
        state = self._run_epochs(state)
        with trace.sync("committed"):
            self.stats.committed += int(state.found.sum())
        with trace.span("spray.glue.hits"):
            best_prim = state.best_prim[inv]
            if self.backend == "jnp":
                found = state.found[inv]
                return Hits(t=torch.where(found, state.best_t[inv], tmax),
                            prim=best_prim, u=state.best_u[inv],
                            v=state.best_v[inv], valid=found)
            # the kernels return (t, prim) only; (t, u, v) are recomputed
            # against the committed triangle, as the other intersectors do
            t, u, v, valid = traverse.attrs_for_prims(
                self.v0, self.e1, self.e2, best_prim, o, d,
                state.best_t[inv], tmax)
            return Hits(t=torch.where(valid, t, tmax), prim=best_prim, u=u,
                        v=v, valid=valid)

    def occluded(self, o, d, tmax):
        with trace.span("spray.glue.partition"):
            perm, inv = self._wavefront_perm(o, d, tmax)
            state = init_state(self.dset, o[perm], d[perm],
                               torch.zeros_like(tmax), tmax[perm],
                               occ_mode=True)
        state = self._run_epochs(state, any_hit=True)
        with trace.span("spray.glue.hits"):
            return state.found[inv]
