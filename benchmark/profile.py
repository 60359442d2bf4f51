"""Reduction of a torch.profiler trace to the records the readers use.

Device time is the union of the intervals of the device's kernels, copies
and sets, so work that overlaps on two streams counts once (the rule of
the repository's earlier chip profiles).  Only device events count as
device time: a host op's row also carries the time of the kernels it
launched.  An idle gap is a stretch between two device intervals; it is
named by the innermost host event running at its middle, or "python"
where none runs.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field


@dataclass
class Interval:
    name: str
    start_us: float
    end_us: float


@dataclass
class Trace:
    device: list = field(default_factory=list)  # Interval per device event
    host: list = field(default_factory=list)  # Interval per host event


def from_profiler(prof):
    """A Trace of a finished torch.profiler.profile."""
    from torch.autograd import DeviceType  # noqa: PLC0415

    tr = Trace()
    for e in prof.events():
        iv = Interval(e.name, float(e.time_range.start),
                      float(e.time_range.end))
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == DeviceType.CUDA:
            tr.device.append(iv)
        else:
            tr.host.append(iv)
    return tr


def merged(intervals):
    """The union of (start, end) pairs as sorted disjoint pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_us(intervals):
    """Length of the union of (start, end) pairs."""
    return sum(e - s for s, e in merged(intervals))


def top_device_ops(trace, k=10):
    """[[name, seconds]] of the k device event names with the most time."""
    tot = {}
    for iv in trace.device:
        tot[iv.name] = tot.get(iv.name, 0.0) + (iv.end_us - iv.start_us)
    top = sorted(tot.items(), key=lambda kv: kv[1], reverse=True)[:k]
    return [[name[:120], us / 1e6] for name, us in top]


def idle_gaps(trace, k=10):
    """[[host activity, seconds]] of the k host activities under which the
    device stood idle longest, summed over the gaps between device
    intervals."""
    busy = merged((iv.start_us, iv.end_us) for iv in trace.device)
    host = sorted(trace.host, key=lambda iv: iv.start_us)
    starts = [iv.start_us for iv in host]
    tot = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        name = "python"
        i = bisect.bisect_right(starts, mid) - 1
        # the most recently started host event still running is innermost
        for j in range(i, max(-1, i - 256), -1):
            if host[j].end_us >= mid:
                name = host[j].name
                break
        tot[name] = tot.get(name, 0.0) + (s1 - e0)
    top = sorted(tot.items(), key=lambda kv: kv[1], reverse=True)[:k]
    return [[name[:120], us / 1e6] for name, us in top]
