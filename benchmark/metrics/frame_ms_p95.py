"""The 95th percentile of every frame of the window, each timed alone."""

from benchmark.window import p95_ms


def read(rec):
    return p95_ms(rec.times) if rec.times else None
