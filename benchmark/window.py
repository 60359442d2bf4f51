"""The arithmetic of a measured window: every step of the window counts."""

from __future__ import annotations

import math


def mean_ms(window_s, n_steps):
    """The window's seconds x 1000 over the steps it completed."""
    return window_s * 1e3 / n_steps


def p95_ms(step_times_s):
    """The 95th percentile of every step's time, by nearest rank: the
    smallest time that at least 95% of the steps do not exceed."""
    times = sorted(step_times_s)
    return times[max(0, math.ceil(0.95 * len(times)) - 1)] * 1e3


def run_window(step, seconds, clock, agree=None):
    """Call step() back to back until `seconds` have passed since the first
    call began: (step times in s, window s, last output).  In a cell of
    many ranks, `agree(done)` hands rank 0's decision to every rank, after
    each step's end time is read, so that all step as often as rank 0."""
    times = []
    start = clock()
    while True:
        t0 = clock()
        out = step()
        t1 = clock()
        times.append(t1 - t0)
        done = t1 - start >= seconds
        if agree is not None:
            done = agree(done)
        if done:
            return times, t1 - start, out
