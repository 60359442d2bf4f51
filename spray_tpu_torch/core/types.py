"""Core SoA value types as plain frozen dataclasses (no pytree registration).

Counterpart of ``spray_tpu/core/types.py``.  A wavefront of N rays is a set of
parallel (N, ...) tensors; `Hits` is the nearest-hit record of one.  `Scene`
and `Camera` hold host arrays (numpy); the device code moves them to tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class Hits:
    """Nearest-hit records for a wavefront (all (N,) tensors)."""

    t: Any  # f32 hit distance (tmax where miss)
    prim: Any  # i32 global triangle id (-1 where miss)
    u: Any  # f32 barycentric
    v: Any  # f32 barycentric
    valid: Any  # bool


@dataclasses.dataclass(frozen=True)
class Scene:
    """Triangle soup + per-face Lambertian material (numpy arrays)."""

    vertices: Any  # (V, 3) f32
    faces: Any  # (F, 3) i32
    albedo: Any  # (F, 3) f32
    emission: Any  # (F, 3) f32

    @property
    def num_faces(self):
        return self.faces.shape[0]


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera; basis precomputed host-side (float32 numpy arrays)."""

    eye: Any  # (3,) f32
    lower_left: Any  # (3,) f32 image-plane point of pixel (0, 0) corner
    du: Any  # (3,) f32 image-plane step per pixel in x
    dv: Any  # (3,) f32 image-plane step per pixel in y
    width: int
    height: int
