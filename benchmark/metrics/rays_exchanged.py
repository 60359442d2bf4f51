"""Rays sent to their owners per traced frame, summed over the ranks: the
program's `rays_exchanged` counter (each ray counted once a round it is
sent; its answer comes back in the same round)."""

from benchmark.metrics._spans import counter_per_step


def read(rec):
    return counter_per_step(rec, "rays_exchanged")
