"""Faults planted under the timed path, to show that the check catches
them (the correctness calibration on the card and the CPU tests).

- "unchanged": the step returns without rendering: every path's radiance
  is zero, so the image and the gradients are zero.
- "half": half of the paths (every other lane) are left out and the rest
  count double: the mean taken over the rest.
- "altered": one lane in 8 of every intersect call that hits gets the id
  of the triangle half the scene away as its hit: an answer altered where
  it is produced.  It wraps the entry's `intersector`: the object the
  program calls, or, where the program builds one a frame, its class.
- "exchange": every `torch.distributed.all_to_all_single` delivers the
  rows from one peer (the next rank) zeroed, so rays sent between cards
  and their answers are lost: the exchange between chips left out.

The first three apply to every cell, "exchange" only to a cell of more
than one chip (`applicable`): a one-chip cell has no exchange between
chips to leave out.  In a cell of many chips each rank plants the fault
under its own entry.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

FAULTS = ("unchanged", "half", "altered", "exchange")


def applicable(chips):
    """The faults a cell of `chips` chips can have."""
    return FAULTS if chips > 1 else FAULTS[:3]


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
        target = ent.intersector  # an intersector, or a class of them
        orig = target.intersect
        own = vars(target).get("intersect")

        def broken(*args):  # (o, d, tmin, tmax), after self on a class
            h = orig(*args)
            lane = torch.arange(h.prim.shape[0], device=h.prim.device)
            hit = h.valid & (lane % 8 == 0)
            prim = torch.where(hit, (h.prim + n_faces // 2) % n_faces, h.prim)
            return dataclasses.replace(h, prim=prim.to(h.prim.dtype))

        target.intersect = broken
        try:
            yield
        finally:
            if own is None:
                del target.intersect
            else:
                target.intersect = own
    elif name == "exchange":
        import torch.distributed as dist  # noqa: PLC0415

        orig = dist.all_to_all_single

        def broken(output, input, output_split_sizes=None,  # noqa: A002
                   input_split_sizes=None, group=None, async_op=False):
            work = orig(output, input, output_split_sizes, input_split_sizes,
                        group=group, async_op=async_op)
            if work is not None:
                work.wait()
            world = dist.get_world_size(group)
            peer = (dist.get_rank(group) + 1) % world
            sizes = output_split_sizes or [output.shape[0] // world] * world
            lo = sum(sizes[:peer])
            output[lo:lo + sizes[peer]] = 0
            return work

        dist.all_to_all_single = broken
        try:
            yield
        finally:
            dist.all_to_all_single = orig
    else:
        raise ValueError(f"fault: want one of {FAULTS}, got {name!r}")
