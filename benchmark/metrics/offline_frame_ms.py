"""The window's seconds x 1000 over the frames it completed, in a cell
whose frames the device's kernels decide (its own bound: its runs spread
far less than the host-bound frame cells')."""

from benchmark.window import mean_ms


def read(rec):
    return mean_ms(rec.window_s, len(rec.times)) if rec.times else None
