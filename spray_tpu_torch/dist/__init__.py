"""Distributed rendering on torch.distributed (counterpart of
``spray_tpu/dist``): one process per rank, gloo on the CPU, NCCL on the
card.

  - `launch.run_world` starts the ranks and joins them to one group;
  - `rayshard`: pixels sharded over the ranks against a replicated scene,
    the gradients all-reduced;
  - `epochs`: the in-situ renderer, domains owned by ranks and rays
    exchanged between them in bucketed all-to-all epochs;
  - `dryrun`: the three of them on tiny scenes, one line of numbers.

The reference runs one shard_map body per device inside one process; here
each rank runs that body in its own process with explicit collectives, and
a world of one rank still runs every collective through its group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# calls of each collective and host syncs of the epoch loop, by this process
# (the dist analog of the kernels' launch counts)
collectives = {"all_reduce": 0, "all_to_all": 0, "all_gather": 0,
               "host_syncs": 0}


def reset_collectives():
    for k in collectives:
        collectives[k] = 0


def all_reduce(x, mesh):
    """Sum x over the mesh's ranks, in place; returns x."""
    collectives["all_reduce"] += 1
    dist.all_reduce(x, group=mesh.group)
    return x


def all_gather(x, mesh):
    """The (size * n, ...) concatenation of every rank's (n, ...) x."""
    collectives["all_gather"] += 1
    out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
    return out


def all_to_all(x, mesh):
    """Rows [r*b, (r+1)*b) of x go to rank r; returns the rows received,
    rank r's in rows [r*b, (r+1)*b) (equal splits)."""
    collectives["all_to_all"] += 1
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=mesh.group)
    return out
