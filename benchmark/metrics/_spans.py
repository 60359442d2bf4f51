"""What the readers of the program's own spans and counters share.

The program (`spray_tpu_torch.trace`) opens a span named `spray.<layer>.
<what>` around each layer's work while a profiler records; the profiler
keeps each as a host op beside the device's events.  An idle gap of the
device (between merged device intervals, as in `profile.idle_gaps`) is put
down to the innermost `spray.` span running at its middle: aten ops and
other host events are passed over, and so is an enclosing `spray.step` or
`spray.frame` span whenever a layer span inside it runs.  A program
without these spans gives these readers nothing to read (None).
"""

from __future__ import annotations

import bisect

from benchmark.profile import merged

PREFIX = "spray."


def program_spans(trace):
    """The trace's `spray.` host intervals, by start (outer first on a tie)."""
    return sorted((iv for iv in trace.host if iv.name.startswith(PREFIX)),
                  key=lambda iv: (iv.start_us, -iv.end_us))


def idle_us_by_span(trace):
    """{innermost program span at each idle gap's middle, or None where no
    program span runs: idle us summed over the gaps}."""
    busy = merged((iv.start_us, iv.end_us) for iv in trace.device)
    spans = program_spans(trace)
    out, stack, k = {}, [], 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        while k < len(spans) and spans[k].start_us <= mid:
            while stack and stack[-1].end_us < spans[k].start_us:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1].end_us < mid:
            stack.pop()
        # spans nest on the one host thread: the newest running is innermost
        name = next((iv.name for iv in reversed(stack) if iv.end_us >= mid),
                    None)
        out[name] = out.get(name, 0.0) + (s1 - e0)
    return out


def idle_ms(rec, prefix):
    """Device-idle ms per traced step whose innermost program span starts
    with `prefix`; None without program spans."""
    if rec.trace is None or not program_spans(rec.trace):
        return None
    us = sum(v for name, v in idle_us_by_span(rec.trace).items()
             if name is not None and name.startswith(prefix))
    return us / 1e3 / rec.traced_steps


def syncs_per_step(rec, in_sched):
    """`spray.sync.` spans per traced step that lie inside a scheduler span
    (`spray.sched.`), or with in_sched False outside every one; None
    without program spans."""
    if rec.trace is None:
        return None
    spans = program_spans(rec.trace)
    if not spans:
        return None
    sched = merged((iv.start_us, iv.end_us) for iv in spans
                   if iv.name.startswith("spray.sched."))
    starts = [s for s, _ in sched]
    n = 0
    for iv in spans:
        if iv.name.startswith("spray.sync."):
            i = bisect.bisect_right(starts, iv.start_us) - 1
            inside = i >= 0 and iv.end_us <= sched[i][1]
            n += inside == in_sched
    return n / rec.traced_steps


def counter_per_step(rec, name):
    """The program's counter `name` over the traced window
    (`spray_tpu_torch.trace.read()`) per traced step; None where the
    program has no such counter or nothing added to it."""
    try:
        from spray_tpu_torch import trace  # noqa: PLC0415
    except ImportError:
        return None
    v = trace.read().get(name)
    return None if v is None else v / rec.traced_steps
