"""The window's seconds x 1000 over the training steps it completed."""

from benchmark.window import mean_ms


def read(rec):
    return mean_ms(rec.window_s, len(rec.times)) if rec.times else None
