"""Ray-triangle tests per step of the traversal kernels, from their counter
buffer."""

from benchmark.metrics._spans import counter_per_step


def read(rec):
    return counter_per_step(rec, "tri_tests")
