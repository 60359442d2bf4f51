"""Faults planted under the timed path, to show that the check catches
them (the correctness calibration on the card and the CPU tests).

- "unchanged": the step returns without rendering: every path's radiance
  is zero, so the image and the gradients are zero.
- "half": half of the paths (every other lane) are left out and the rest
  count double: the mean taken over the rest.
- "altered": one lane in 8 of every intersect call that hits gets the id
  of the triangle half the scene away as its hit: an answer altered where
  it is produced.

A one-chip cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def planted(name, ent, n_faces):
    """Plant fault `name` under the entry `ent` (of a scene of `n_faces`
    triangles) for the duration."""
    from spray_tpu_torch.integrators import wavefront  # noqa: PLC0415

    if name in ("unchanged", "half"):
        orig = wavefront.sample_wavefront

        def broken(*args, **kw):
            out = orig(*args, **kw)
            rad, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
            if name == "unchanged":
                rad = torch.zeros_like(rad).detach()
            else:
                lane = torch.arange(rad.shape[0], device=rad.device)
                rad = rad * ((lane % 2 == 0).to(rad.dtype) * 2.0)[:, None]
            return (rad, *rest) if rest else rad

        wavefront.sample_wavefront = broken
        try:
            yield
        finally:
            wavefront.sample_wavefront = orig
    elif name == "altered":
        isect = ent.intersector
        orig = isect.intersect

        def broken(o, d, tmin, tmax):
            h = orig(o, d, tmin, tmax)
            lane = torch.arange(h.prim.shape[0], device=h.prim.device)
            hit = h.valid & (lane % 8 == 0)
            prim = torch.where(hit, (h.prim + n_faces // 2) % n_faces, h.prim)
            return dataclasses.replace(h, prim=prim.to(h.prim.dtype))

        isect.intersect = broken
        try:
            yield
        finally:
            del isect.intersect
    else:
        raise ValueError(f"fault: want one of {FAULTS}, got {name!r}")
