"""Domain residency manager: K device slots with LRU eviction (counterpart
of ``spray_tpu/residency/manager.py``, provider form only).

Every domain lives pre-built in host memory; `domain_provider(d)` returns
its pages as a dict of host arrays (numpy or CPU tensors).  `acquire` uploads
the missing ones into slots, evicting the least recently used domain that
the request does not name; a hit reuses the device copy.  Order of eviction
and the counters (`loads`, `hits`, `prefetches`) follow the reference.

On the card, host pages are pinned and each upload runs `non_blocking` on a
side stream, recording an event, so uploads overlap the kernels of the
current epoch.  A page is handed out only after the consuming stream waits
on its event, and each of its tensors is marked with `record_stream` for
that stream, so the allocator never reuses an evicted page's memory while a
queued kernel still reads it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..core.device import resolve_device


class ResidencyManager:
    def __init__(self, num_slots, domain_provider, device=None):
        self.num_slots = int(num_slots)
        self.device = resolve_device(device)
        self._provider = domain_provider
        self._resident = {}  # domain id -> (page dict of tensors, event)
        self._lru = []  # domain ids, least recent first
        self.loads = 0  # domain uploads
        self.hits = 0
        self.prefetches = 0  # uploads issued ahead of schedule
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def _upload(self, d):
        host = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v)
                for k, v in self._provider(d).items()}
        if self._stream is None:
            return {k: v.to(self.device) for k, v in host.items()}, None
        with torch.cuda.stream(self._stream):
            page = {k: (v if v.is_pinned() else v.pin_memory()).to(
                self.device, non_blocking=True) for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return page, event

    def _hand_out(self, d):
        page, event = self._resident[d]
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for v in page.values():
                v.record_stream(current)
        return page

    def _evict(self, d):
        self._lru.remove(d)
        del self._resident[d]

    def acquire(self, domain_ids):
        """Make `domain_ids` resident (len <= num_slots).  Returns their page
        dicts in the same order."""
        with trace.span("spray.residency.acquire"):
            ids = [int(d) for d in domain_ids]
            if len(ids) > self.num_slots:
                raise ValueError(
                    f"requested {len(ids)} domains > {self.num_slots} slots")
            out = []
            for d in ids:
                if d in self._resident:
                    self.hits += 1
                    self._lru.remove(d)
                else:
                    while len(self._resident) >= self.num_slots:
                        # evict the least recently used domain not requested
                        cand = next((c for c in self._lru if c not in ids),
                                    None)
                        if cand is None:
                            raise RuntimeError("all slots pinned by request")
                        self._evict(cand)
                    with trace.span("spray.residency.upload"):
                        self._resident[d] = self._upload(d)
                    self.loads += 1
                self._lru.append(d)
                out.append(self._hand_out(d))
            return out

    def prefetch(self, domain_ids, pinned=()):
        """Start uploads of `domain_ids` into free or evictable slots without
        evicting anything in `pinned` (the scheduled set); they overlap the
        current epoch.  A prefetched domain is least recent, so a wrong
        guess is evicted first.  Returns how many uploads started."""
        with trace.span("spray.residency.prefetch"):
            pinned = {int(p) for p in pinned}
            started = 0
            for d in domain_ids:
                d = int(d)
                if d in self._resident:
                    continue
                if len(self._resident) >= self.num_slots:
                    evictable = [c for c in self._lru if c not in pinned]
                    if not evictable:
                        break  # every slot pinned: no room to prefetch
                    self._evict(evictable[0])
                with trace.span("spray.residency.upload"):
                    self._resident[d] = self._upload(d)
                self._lru.insert(0, d)
                self.loads += 1
                self.prefetches += 1
                started += 1
            return started

    def peek(self, domain_id):
        """Pages of an already resident domain, without upload or LRU touch
        (unscheduled resident domains join the speculative trace)."""
        return self._hand_out(int(domain_id))

    @property
    def resident_ids(self):
        return set(self._resident)
