"""Rounds of the collective epoch loop per traced frame: the program's
`dist_rounds` counter, the rounds of every intersect and occluded call of
the frame (each round one exchange of rays to their owners and back)."""

from benchmark.metrics._spans import counter_per_step


def read(rec):
    return counter_per_step(rec, "dist_rounds")
