"""Carry state in from numpy arrays (e.g. from the JAX reference package),
so both packages can run on identical scenes, cameras and cluster pages.

Cluster pages go through
``spray_tpu_torch.kernels.multidomain.MultiDomainClusterIntersector.from_pages``,
a binned build through ``binned_arrays`` and
``BinnedIntersector.from_arrays`` / ``SweepIntersector.from_arrays``, a
brute triangle table through ``brute_arrays`` and
``PallasBruteIntersector.from_arrays``, and a partitioned domain set through
``domain_set_from_numpy`` (then ``OOCIntersector(dset=...)`` or
``MultiDomainIntersector(dset=...)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .core.types import Camera, Scene
from .domains.partition import DomainSet
from .kernels.binned import BinnedScene


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


def binned_arrays(src):
    """The six arrays of a binned build (`BinnedScene.FIELDS`) as numpy,
    from any object that has them as attributes: a `BinnedScene` or a
    binned / sweep intersector of either package."""
    dtypes = {"tri_ids": np.int32}
    return {
        k: np.array(getattr(src, k), dtypes.get(k, np.float32))  # a copy
        for k in BinnedScene.FIELDS
    }


def brute_arrays(src):
    """(tri9 (T, 9) f32, ids (T,) i32) as numpy from a brute-kernel
    intersector of either package."""
    return np.array(src.tri9, np.float32), np.array(src.ids, np.int32)


def domain_set_from_numpy(src):
    """The port's `DomainSet` from any object with a DomainSet's fields (a
    reference `DomainSet`, say), its arrays copied as numpy."""
    arrays = {f.name: np.array(getattr(src, f.name))
              for f in dataclasses.fields(DomainSet) if f.name != "leaf_size"}
    return DomainSet(**arrays, leaf_size=int(src.leaf_size))
