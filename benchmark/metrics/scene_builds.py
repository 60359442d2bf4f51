"""Builds of the scene-only shading inputs per traced step: the program's
`scene_builds` counter, 1 for each build (`diff.scene_consts`,
`wavefront.scene_arrays_for` on a new scene or device) and 0 for each
reuse, so a window that only reuses reads 0."""

from benchmark.metrics._spans import counter_per_step


def read(rec):
    return counter_per_step(rec, "scene_builds")
