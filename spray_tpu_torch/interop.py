"""Carry state in from numpy arrays (e.g. from the JAX reference package),
so both packages can run on identical scenes, cameras and cluster pages.

Cluster pages go through
``spray_tpu_torch.kernels.multidomain.MultiDomainClusterIntersector.from_pages``.
"""

from __future__ import annotations

import numpy as np

from .core.types import Camera, Scene


def scene_from_arrays(vertices, faces, albedo, emission):
    return Scene(
        vertices=np.asarray(vertices, np.float32),
        faces=np.asarray(faces, np.int32),
        albedo=np.asarray(albedo, np.float32),
        emission=np.asarray(emission, np.float32),
    )


def camera_from_arrays(eye, lower_left, du, dv, width, height):
    return Camera(
        eye=np.asarray(eye, np.float32),
        lower_left=np.asarray(lower_left, np.float32),
        du=np.asarray(du, np.float32),
        dv=np.asarray(dv, np.float32),
        width=int(width),
        height=int(height),
    )
