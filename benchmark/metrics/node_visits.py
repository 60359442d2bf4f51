"""BVH node visits per step of the traversal kernels (`nearest_kernel`,
`nearest_slot_kernel`, `anyhit_kernel`), from their counter buffer."""

from benchmark.metrics._spans import counter_per_step


def read(rec):
    return counter_per_step(rec, "node_visits")
