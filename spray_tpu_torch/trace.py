"""Spans and counters of the port, on torch.profiler's clock.

Tracing is on exactly while a torch profiler records: no flag turns it on.
Off, `span` and `sync` return a shared no-op context after one C call;
`count` records nothing.  On, a span is a
`torch._C._profiler._RecordFunctionFast` range, which the profiler keeps as
a host op beside the aten ops and the device's events, on its own clock
(a `record_function` range would be a user annotation instead).  Spans nest
on the one host thread that drives a step: every span of a step lies
inside its `spray.step` or `spray.frame` span.

Span names are `spray.<layer>.<what>`, with the layers of PERF.md:
`spray.step` / `spray.frame` (entry), `spray.glue.*` (wavefront glue),
`spray.sched.*` (scheduler), `spray.residency.*`, `spray.autograd.*`,
`spray.dist.*` (collective epochs: `route`, `exchange`, `trace`, `commit`,
`reduce` of the in-situ epoch loop, `gather` of its frame), and
`spray.sync.<site>` around each host read of a device value.

Counters (`read()`): `live_rays` (the rays each sample wavefront traces,
the sums that make `rays_traced`), `scene_builds` (1 for each build of a
scene's scene-only shading inputs, 0 for each reuse), `dist_rounds` (the
rounds of each collective epoch loop), `rays_exchanged` (the rays those
rounds sent, summed over the ranks), and `node_visits`, `leaf_visits`,
`tri_tests`, which the traversal kernels add into one (3,) int64 device
buffer (`kernel_counters`).  Device values are kept as they
are and summed only in `read()`, after the window: a counter adds no host
read and no launch to the traced path.  The totals start anew at the first
span or count after a profiler starts (once a span, count or `read()` has
seen none recording).
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


class _Window:
    """What one profiled window recorded."""

    def __init__(self):
        self.ints = {}  # name -> host int total
        self.tensors = {}  # name -> [device int64 scalars]
        self.kernel = {}  # device -> (3,) int64 buffer of the kernels


_window = _Window()
_recording = False  # whether the last span or count saw a profiler


def _tracing():
    """True while a profiler records; the first call after it started
    opens a new window."""
    global _recording, _window
    if not _profiler_enabled():
        _recording = False
        return False
    if not _recording:
        _recording = True
        _window = _Window()
    return True


def span(name):
    """A profiler range named `name` while tracing, else a no-op context."""
    return _RecordFunctionFast(name) if _tracing() else _OFF


def sync(site):
    """The span `spray.sync.<site>` around a host read of a device value."""
    return span("spray.sync." + site)


def count(name, value):
    """Add `value`, a host int or a device int64 scalar the program already
    computed, to counter `name` while tracing."""
    if not _tracing():
        return
    if isinstance(value, torch.Tensor):
        _window.tensors.setdefault(name, []).append(value)
    else:
        _window.ints[name] = _window.ints.get(name, 0) + int(value)


def kernel_counters(device):
    """While tracing, the window's (3,) int64 buffer on `device` that the
    traversal kernels add (node visits, leaf visits, ray-triangle tests)
    to, zeroed at its first use in the window; else None."""
    if not _tracing():
        return None
    buf = _window.kernel.get(device)
    if buf is None:
        buf = _window.kernel[device] = torch.zeros(3, dtype=torch.int64,
                                                   device=device)
    return buf


def read():
    """{counter: int} of the last window; a counter nothing added to is
    left out.  Reads the device, so call it after the window: the next
    profiler then opens a new one."""
    global _recording
    if not _profiler_enabled():
        _recording = False
    out = dict(_window.ints)
    for name, values in _window.tensors.items():
        out[name] = out.get(name, 0) + sum(int(v) for v in values)
    for buf in _window.kernel.values():
        for name, v in zip(("node_visits", "leaf_visits", "tri_tests"),
                           buf.tolist()):
            out[name] = out.get(name, 0) + v
    return out
