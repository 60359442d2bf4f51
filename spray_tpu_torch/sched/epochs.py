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

The needed-domain and nearest-needed rules and the one-page trace are
`sched/multidomain.py`'s, shared with the in-situ epochs.  One host loop
(`OOCIntersector._run_epochs`) and one epoch step (`epoch_batch`) serve
every mode and backend.  Two backends, as in the reference.  The cluster
backend: each slot's trace is one launch of the CUDA `nearest_slot` kernel
(or of `anyhit` with a one-entry domain list for occlusion rays) on the
slot's cluster pages (`PageWave`); the reference's device-side
`lax.while_loop` over epochs becomes a Python loop over device tensors
that reads its `more_work` flag once per epoch: one host sync per epoch,
where the reference pays none.  The jnp backend (the reference's name,
kept so that the two APIs match): each slot's trace walks the domain's BVH
(`bvh/traverse.py`, a `partition_scene` domain set), one epoch a batch.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from .. import trace
from ..core.device import resolve_device
from ..core.types import Hits
from ..kernels import traverse
from ..kernels.multidomain import _live_partition, build_cluster_domains
from ..residency.manager import ResidencyManager
from .multidomain import (
    BVH_FIELDS, DeviceDomainSet, PageWave, domain_entries, nearest_needed,
    needed, trace_domain,
)

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


def needed_mask(state):
    """(N, D) ray-needs-domain mask == implicit queue membership."""
    return needed(state.entry_t, state.processed, state.best_t, state.found,
                  state.occ_mode)


def queue_counts(state):
    """(D,) queue sizes: each ray is queued for its nearest unprocessed
    overlapped domain only (the reference's allgathered counts)."""
    nearest, has, _ = nearest_needed(needed_mask(state), state.entry_t)
    return torch.bincount(nearest[has], minlength=state.entry_t.shape[1])


def second_queue_counts(state):
    """(D,) counts of each ray's second-nearest needed domain: where it goes
    once its nearest is traced, unless it commits first (the prefetch
    predictor)."""
    nearest, _, masked = nearest_needed(needed_mask(state), state.entry_t)
    masked2 = masked.scatter(1, nearest[:, None], np.inf)
    mn2, second = masked2.min(dim=1)
    return torch.bincount(second[torch.isfinite(mn2)],
                          minlength=state.entry_t.shape[1])


def schedule_top_k(counts, k):
    """The K largest nonempty queues (biggest-queue-first)."""
    order = np.argsort(-counts, kind="stable")
    return [int(d) for d in order[:k] if counts[d] > 0]


def _derive(state, best_t, found, processed, speculate, spec_bound):
    """(need, nearest, has_need) of an epoch; spec_bound=k (with speculate)
    keeps only each ray's k nearest needed domains."""
    need = needed(state.entry_t, processed, best_t, found, state.occ_mode)
    if spec_bound is not None and speculate:
        ent = torch.where(need, state.entry_t,
                          torch.full_like(state.entry_t, np.inf))
        k = min(spec_bound, need.shape[1]) - 1
        thr = torch.sort(ent, dim=1).values[:, k]
        need = need & (state.entry_t <= thr[:, None])
    nearest, has_need, _ = nearest_needed(need, state.entry_t)
    return need, nearest, has_need


def epoch_batch(state, slots, trace_slot, speculate, max_epochs=None,
                any_hit=False, spec_bound=None):
    """Trace epochs over the resident slots [(domain id, pages), ...].

    trace_slot(slot, active, live, best_t, any_hit) is the backend's trace
    of one slot: occluded (N,) bool for any_hit, else (hit flags, {state
    field: value}) to keep where the hit is nearer.  max_epochs=None runs
    exactly one epoch and reads nothing; else epochs run until no ray needs
    a resident domain (one flag read an epoch) or max_epochs.  Returns
    (state, epochs, traced, speculated, more): epochs an int, the counts
    device tensors, more whether resident work is left (None after the one
    epoch; epochs == max_epochs alone is not a failure)."""
    resident = None
    if max_epochs is not None:
        resident = torch.zeros(state.entry_t.shape[1], dtype=torch.bool,
                               device=state.o.device)
        resident[[d for d, _ in slots]] = True
    best = {k: getattr(state, k)
            for k in ("best_t", "best_prim", "best_u", "best_v")}
    found, processed = state.found, state.processed.clone()
    traced = spec = torch.zeros((), dtype=torch.int64, device=state.o.device)
    epochs, more = 0, None
    while True:
        need, nearest, has_need = _derive(state, best["best_t"], found,
                                          processed, speculate, spec_bound)
        if resident is not None:
            if speculate:
                more = (need & resident[None, :]).any()
            else:
                more = (has_need & resident[nearest]).any()
            with trace.sync("more"):
                more = bool(more)
            if epochs >= max_epochs or not more:
                break
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
                    f = trace_slot(slot, active, live, best["best_t"],
                                   True) & active
                else:
                    f, hit = trace_slot(slot, active, live, best["best_t"],
                                        False)
                    f = f & active
                    upd = f & (hit["best_t"] < best["best_t"])
                    best.update({k: torch.where(upd, v, best[k])
                                 for k, v in hit.items()})
                found = found | f
                processed[:, d_id] |= active
        epochs += 1
        if resident is None:
            break
    state = dataclasses.replace(state, **best, found=found,
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
        # every domain fits the slots: the whole trace is one batch
        n_dom = self.dset.num_domains
        self.all_resident = self.device_batched and n_dom <= self.sched_width
        if self.all_resident:
            ids = list(range(n_dom))
            self._slots_all = list(zip(ids, self.residency.acquire(ids)))

    def _absorb(self, epochs, traced, spec, entry):
        self.stats.epochs += epochs
        self.stats.rays_traced += traced
        self.stats.rays_speculated += spec
        self.epoch_log.append({
            **{k: v for k, v in entry.items() if v is not None},
            "traced": traced, "speculated": spec,
            "loads": self.residency.loads, "hits": self.residency.hits,
            "prefetches": self.residency.prefetches,
        })

    def _schedule(self, state):
        """(counts, scheduled, slots) of the next batch from one read of the
        queue counts, with the lookahead's uploads started; scheduled is
        empty when no ray is queued.  slots: (domain id, pages) of the
        scheduled domains plus, when speculating, resident domains with
        queued rays (free extra work)."""
        # batched: the next batch is predicted from each ray's
        # second-nearest needed domain; per-epoch: from the current queues
        second = self.lookahead and self.device_batched
        with trace.span("spray.sched.counts"):
            counts = queue_counts(state)
            if second:
                counts = torch.stack([counts, second_queue_counts(state)])
            with trace.sync("counts"):
                counts = counts.cpu().numpy()
        counts, predicted = (counts[0], counts[1]) if second else (counts,
                                                                   counts)
        sched = schedule_top_k(counts, self.sched_width)
        if not sched:
            return counts, sched, []
        slots = list(zip(sched, self.residency.acquire(sched)))
        if self.speculate:
            for d in self.residency.resident_ids:
                if len(slots) >= self.sched_width:
                    break
                if d not in sched and counts[d] > 0:
                    slots.append((int(d), self.residency.peek(d)))
        if self.lookahead:
            # the predicted queues, then current-queue order
            with trace.span("spray.sched.lookahead"):
                ids = [d for d, _ in slots]
                nxt = [int(d) for d in np.argsort(-predicted, kind="stable")
                       if predicted[d] > 0 and int(d) not in ids]
                nxt += [int(d) for d in np.argsort(-counts, kind="stable")
                        if counts[d] > 0 and int(d) not in ids
                        and int(d) not in nxt]
                self.residency.prefetch(nxt[:self.reserve], pinned=sched)
        return counts, sched, slots

    def _slot_trace(self, state):
        """The backend's trace of one resident slot (`epoch_batch`'s
        trace_slot) for this batch's wavefront."""
        if self.backend == "cluster":
            wave = PageWave(state.o, state.d, state.tmin, state.best_t)

            def trace_page(slot, active, live, best_t, any_hit):
                out = wave.trace(slot, live, best_t, any_hit, self.depth)
                if any_hit:
                    return out
                t, prim = out
                return prim >= 0, {"best_t": t, "best_prim": prim}
            return trace_page

        def walk(slot, active, live, best_t, any_hit):
            # the nearest walk over each active ray's window, for occlusion
            # rays too, as the reference's epoch step does
            window = torch.where(active, best_t, torch.zeros_like(best_t))
            t, p, u, v, f = trace_domain(self.dset.domain_bvh(slot), state.o,
                                         state.d, state.tmin, window)
            return f, {"best_t": t, "best_prim": p, "best_u": u, "best_v": v}
        return walk

    def _run_epochs(self, state, any_hit=False):
        """The scheduler's host loop.  A batch reads the queue counts,
        schedules the K largest queues, starts the lookahead's uploads, runs
        epochs over the resident slots, reads the work counts and logs a
        row.  The modes are data, not code paths:
          - all-resident (every domain fits the slots): one batch of every
            domain, no counts read; work left raises;
          - batched: epochs until no resident domain has work, bounded
            speculation, the any-hit kernel for occlusion;
          - per-epoch (device_batched=False, and the jnp backend): one epoch
            a batch, no flag read, the nearest trace for occlusion, as in
            the reference's epoch step."""
        batched = self.device_batched
        for _ in range(1 if self.all_resident else self.max_epochs):
            with trace.span("spray.sched.batch"):
                if self.all_resident:
                    counts, slots = None, self._slots_all
                    sched = [d for d, _ in slots]
                else:
                    counts, sched, slots = self._schedule(state)
                    if not sched:
                        break
                with trace.span("spray.sched.epochs"):
                    state, epochs, traced, spec, more = epoch_batch(
                        state, slots, self._slot_trace(state), self.speculate,
                        self.max_epochs if batched else None,
                        any_hit=any_hit and batched,
                        spec_bound=self.spec_bound if batched else None)
                if self.all_resident and more:
                    raise RuntimeError(
                        "epoch loop failed to converge (max_epochs)")
                if counts is not None and epochs == 0:
                    raise RuntimeError(
                        "batched epoch loop made no progress (scheduled "
                        "domains had no resident work)")
                with trace.sync("traced"):
                    traced, spec = torch.stack([traced, spec]).tolist()
                with trace.span("spray.sched.absorb"):
                    # a mode logs no key it has no value for (None)
                    self._absorb(epochs, traced, spec, {
                        "epoch": self.stats.epochs + epochs,
                        "queued": None if counts is None else int(counts.sum()),
                        "scheduled": sched,
                        "resident_extra": (None if counts is None
                                           else len(slots) - len(sched)),
                        "batch_epochs": epochs if batched else None,
                    })
            if self.all_resident:
                break
        else:
            raise RuntimeError("epoch loop failed to converge (max_epochs)")
        self.stats.domain_loads = self.residency.loads
        self.stats.cache_hits = self.residency.hits
        self.stats.prefetches = self.residency.prefetches
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
