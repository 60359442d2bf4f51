"""Rays traced per step: the live rays of each intersect and occluded call (the
program's `live_rays` counter, the count `Pipeline.rays_traced` gives)."""

from benchmark.metrics._spans import counter_per_step


def read(rec):
    return counter_per_step(rec, "live_rays")
