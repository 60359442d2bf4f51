"""Host milliseconds per traced step inside the autograd engine: the union
of the profiler's `autograd::engine::evaluate_function` ranges."""

from benchmark.profile import busy_us

PREFIX = "autograd::engine::evaluate_function"


def read(rec):
    if rec.trace is None:
        return None
    spans = [(iv.start_us, iv.end_us) for iv in rec.trace.host
             if iv.name.startswith(PREFIX)]
    if not spans:
        return None
    return busy_us(spans) / 1e3 / rec.traced_steps
