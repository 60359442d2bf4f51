"""Pixels sharded over the ranks, gradients all-reduced (counterpart of
``spray_tpu/dist/rayshard.py``).

Every rank renders a contiguous shard of the padded pixel ids against the
whole (replicated) scene.  The reference runs that body per device inside
one shard_map and `psum`s the gradients; here each rank runs it in its own
process and all-reduces them: one `all_reduce` per gradient tensor and one
for the loss, after the backward.  The image stays sharded, or is gathered
by `all_gather_into_tensor` for the forward-only render.

A shard's pixels trace in the single-device renderer's tile-swizzle order
(`kernels.common.tile_swizzle_order`), so packets of rays are image tiles
and a one-rank world traces exactly the single-device wavefront.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..diff import DetachedIntersector, diff_scene_arrays, grads_of, scene_consts
from ..integrators import wavefront
from ..kernels.common import tile_swizzle_order
from ..oracle.brute import BruteIntersector
from . import all_gather, all_reduce


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a process group as a 1-D mesh: this process's rank, the
    world size, this rank's device and the group (None: the default)."""

    rank: int
    size: int
    device: torch.device
    group: object = None


def make_mesh(n_devices=None, device=None):
    """The default group as a `Mesh`.  Raises if torch.distributed is not
    initialised, if `n_devices` is not the world size, or if the group's
    backend does not move tensors of `device` (NCCL for the card, gloo for
    the CPU): a collective never detours through another device."""
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: start the "
                           "ranks with dist.launch.run_world")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices} but the world has {size} ranks")
    want = "nccl" if device.type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise ValueError(f"{device.type} tensors need the {want} backend, the "
                         f"group runs {dist.get_backend()}")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(rank=dist.get_rank(), size=size, device=device,
                group=dist.group.WORLD)


def mesh_for(mesh, device):
    """`mesh`, or with None the default group's on `device` (None: the
    card).  A mesh given with a device must be on it."""
    if mesh is None:
        return make_mesh(device=device)
    if device is not None and resolve_device(device).type != mesh.device.type:
        raise ValueError(f"the mesh is on {mesh.device}, the call asks for "
                         f"{device}")
    return mesh


def padded_pixel_ids(camera, n_shards):
    """Flat pixel ids padded to a multiple of n_shards (pad renders pixel 0)."""
    npix = camera.width * camera.height
    pad = (-npix) % n_shards
    ids = np.concatenate(
        [np.arange(npix, dtype=np.uint32), np.zeros(pad, np.uint32)]
    )
    return ids, npix


def _shard(camera, pixel_ids, mesh):
    """This rank's contiguous shard of the padded ids: (trace order, int64
    tensor of the shard's ids in tile-swizzle order; inverse, the gather
    that puts traced rows back in shard order)."""
    ids = np.asarray(pixel_ids).astype(np.int64)
    per = ids.shape[0] // mesh.size
    mine = ids[mesh.rank * per:(mesh.rank + 1) * per]
    place = np.empty(camera.width * camera.height, np.int64)
    place[tile_swizzle_order(camera.width, camera.height)] = np.arange(place.size)
    order = np.argsort(place[mine], kind="stable")
    return (torch.as_tensor(mine[order], device=mesh.device),
            torch.as_tensor(np.argsort(order), device=mesh.device))


def _render_shard(arrays, camera, cfg, intersector, pix, inv):
    """(n, 3) radiance of the shard's pixels over cfg.spp samples, in shard
    order: all samples as one wavefront, a pixel's samples adjacent and
    summed by a reshape."""
    spp = cfg.spp
    smp = torch.arange(spp, dtype=torch.int64, device=pix.device).repeat(
        pix.shape[0])
    rad = wavefront.sample_wavefront(arrays, camera, cfg, intersector, smp,
                                     pix.repeat_interleave(spp))
    return (rad.reshape(-1, spp, 3).sum(dim=1) * (1.0 / spp))[inv]


def make_sharded_render_grad(scene, camera, cfg, mesh=None,
                             make_intersector=None,
                             loss_weights=(0.4, 0.8, 1.3), device=None):
    """Returns step(params, pixel_ids) -> (image shard, loss, grads).

    pixel_ids: all the padded ids (`padded_pixel_ids`); this rank renders
    its contiguous shard of them.  params: {'vertices', 'albedo',
    'emission'} tensors (any subset), the same on every rank.  The loss is
    sum(img * w) / (npix * 3) over the shard, summed over the ranks with
    the gradients: one all_reduce per gradient tensor and one for the loss.
    The discrete search runs in the intersector from `make_intersector`
    (default: the torch brute oracle) on detached rays, its hits
    re-intersected against the live vertices (`DetachedIntersector`)."""
    mesh = mesh_for(mesh, device)
    if make_intersector is None:
        def make_intersector(s):
            return BruteIntersector(s, device=mesh.device)
    base = make_intersector(scene)
    w = torch.tensor(loss_weights, dtype=torch.float32, device=mesh.device)
    npix = camera.width * camera.height
    consts = scene_consts(scene, mesh.device)

    def step(params, pixel_ids):
        pix, inv = _shard(camera, pixel_ids, mesh)
        p = {k: torch.as_tensor(v, device=mesh.device).detach()
             .requires_grad_(True) for k, v in params.items()}
        arrays, vertices, faces = diff_scene_arrays(scene, p, consts)
        isect = DetachedIntersector(base, vertices, faces)
        img = _render_shard(arrays, camera, cfg, isect, pix, inv)
        loss = torch.sum(img * w) / float(npix * 3)
        grads = grads_of(loss, p)
        for g in grads.values():
            all_reduce(g, mesh)
        return img.detach(), all_reduce(loss.detach(), mesh), grads

    return step


def sharded_render(scene, camera, cfg, mesh=None, make_intersector=None,
                   device=None):
    """Forward-only sharded render -> the (H, W, 3) numpy image on every
    rank, gathered with one all_gather_into_tensor."""
    mesh = mesh_for(mesh, device)
    if make_intersector is None:
        def make_intersector(s):
            return BruteIntersector(s, device=mesh.device)
    isect = make_intersector(scene)
    arrays = wavefront.make_scene_arrays(scene, mesh.device)
    ids, npix = padded_pixel_ids(camera, mesh.size)
    pix, inv = _shard(camera, ids, mesh)
    img = all_gather(_render_shard(arrays, camera, cfg, isect, pix, inv), mesh)
    return img[:npix].cpu().numpy().reshape(camera.height, camera.width, 3)
