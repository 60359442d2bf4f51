"""Differentiable rendering path (counterpart of ``spray_tpu/diff``).

  - The intersector produces DISCRETE results (prim ids) from detached rays:
    its kernels never see a tensor that needs a gradient.
  - `reintersect` recomputes (t, u, v) for the committed triangle with torch
    ops on the live vertex tensor, so gradients reach the vertices.
  - Shading reads the live albedo / emission, and normals and light
    geometry are rebuilt from the live vertices.
  - Visibility (which prim is hit, whether a lane is occluded) is piecewise
    constant and detached: the gradient is exact for the shading and
    geometry of the fixed visibility configuration.

Gradients come from torch autograd over these ops; no kernel needs a
backward.  Public API: `make_diff_render_fn`, `render_grad`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..core import geom
from ..core.device import resolve_device
from ..core.types import Hits
from ..integrators import wavefront
from ..kernels.common import tile_swizzle_order
from ..oracle.brute import BruteIntersector


def reintersect(vertices, faces, prim, o, d, t_else, valid):
    """Differentiably recompute (t, u, v, n) for committed prim ids from the
    live vertices.  Lanes that are not a hit read prim 0; they and the hits
    the recompute rejects take t from `t_else`.  The Möller–Trumbore divide
    is guarded, so no inf or NaN reaches a gradient through a branch
    `torch.where` does not take."""
    safe = torch.where(valid, prim, torch.zeros_like(prim)).long()
    tv = wavefront.pgather(vertices, faces[safe].reshape(-1)).reshape(-1, 3, 3)
    v0, v1, v2 = tv[:, 0], tv[:, 1], tv[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    t, u, v, ok = geom.moller_trumbore(o, d, v0, e1, e2)
    t = torch.where(valid & ok, t, t_else)
    n = geom.normalize(geom.cross(e1, e2))
    return t, u, v, n


class DetachedIntersector:
    """Wraps an intersector: the discrete search runs on detached rays and
    windows; hit attributes are re-derived by `reintersect` against the
    live vertex and face tensors."""

    def __init__(self, inner, vertices, faces):
        self.inner = inner
        self.vertices = vertices
        self.faces = faces

    def intersect(self, o, d, tmin, tmax):
        # every input of the search is detached: tmin / tmax carry gradients
        # from earlier bounces' t and light distances
        h = self.inner.intersect(o.detach(), d.detach(), tmin.detach(),
                                 tmax.detach())
        # h.t is the window's tmax on a miss, as `tmax` is; on a grazing hit
        # that the recompute rejects (f32 edge rounding) it is the
        # intersector's own t.  The reference falls back to tmax there: an
        # infinite window then puts the shading point at infinity and NaN
        # into every gradient through the lanes torch.where masks.
        with trace.span("spray.glue.hits"):
            t, u, v, _ = reintersect(self.vertices, self.faces, h.prim, o, d,
                                     h.t, h.valid)
        return Hits(t=t, prim=h.prim, u=u, v=v, valid=h.valid)

    def occluded(self, o, d, tmax):
        return self.inner.occluded(o.detach(), d.detach(), tmax.detach())


def scene_consts(scene, device):
    """The constants of `diff_scene_arrays`, built once a scene: the
    scene's faces (int64) and emission on `device`, its offset epsilon
    (`wavefront.scene_offset_eps`) and the ids of its emissive faces
    (`wavefront.light_ids_static`, int64 on `device`).  Adds 1 to the
    `scene_builds` counter."""
    trace.count("scene_builds", 1)
    return {
        "faces": torch.as_tensor(np.asarray(scene.faces, np.int64),
                                 device=device),
        "emission": torch.as_tensor(np.asarray(scene.emission, np.float32),
                                    device=device),
        "offset_eps": wavefront.scene_offset_eps(scene),
        "light_ids": torch.as_tensor(wavefront.light_ids_static(scene),
                                     device=device),
    }


def diff_scene_arrays(scene, params, consts):
    """Shading arrays from the differentiable params {'vertices', 'albedo',
    'emission'} (any subset; the scene's values stand in for the rest).
    consts is `scene_consts(scene, device)`.  Normals and light arrays are
    rebuilt from the live vertices, so vertex gradients flow through
    shading normals and the NEE estimator; the offset epsilon and the light
    set are the scene's, read from consts.  Adds 0 to the `scene_builds`
    counter.  Returns (arrays, vertices, faces)."""
    trace.count("scene_builds", 0)
    faces = consts["faces"]
    device = faces.device
    vertices = params.get("vertices")
    if vertices is None:
        vertices = torch.as_tensor(np.asarray(scene.vertices, np.float32),
                                   device=device)
    albedo = params.get("albedo")
    if albedo is None:
        albedo = torch.as_tensor(np.asarray(scene.albedo, np.float32),
                                 device=device)
    emission = params.get("emission", consts["emission"])
    arrays = {
        "albedo": albedo,
        "emission": emission,
        "normals": geom.face_normals(vertices, faces),
        "offset_eps": consts["offset_eps"],
        "lights": wavefront.make_light_arrays(vertices, faces, emission,
                                              consts["light_ids"]),
    }
    return arrays, vertices, faces


def make_diff_render_fn(scene, camera, cfg, make_intersector=None,
                        with_stats=False, spp_batch=True, device=None):
    """Returns render(params) -> (H, W, 3) image, differentiable w.r.t. the
    tensors in params, or (image, rays_traced) with with_stats.

    params: dict with any of 'vertices' (V, 3), 'albedo' (F, 3), 'emission'
    (F, 3).  The discrete intersector keeps the ORIGINAL geometry (the
    visibility configuration is frozen at build time); the analytic
    attributes use the live vertices.  spp_batch traces all spp samples as
    one wavefront, the samples of a pixel adjacent, summed by a reshape;
    spp_batch=False traces one wavefront per sample.  Both give the same
    image up to the order of the sample sum."""
    device = resolve_device(device)
    if make_intersector is None:
        def make_intersector(s):
            return BruteIntersector(s, device=device)
    base_intersector = make_intersector(scene)
    npix = camera.width * camera.height
    spp = cfg.spp
    pids = torch.as_tensor(
        tile_swizzle_order(camera.width, camera.height).astype(np.int64),
        device=device)
    inv = torch.argsort(pids)  # trace order -> image order, as a gather
    consts = scene_consts(scene, device)

    def render(params):
        with trace.span("spray.glue.scene_arrays"):
            arrays, vertices, faces = diff_scene_arrays(scene, params, consts)
        intersector = DetachedIntersector(base_intersector, vertices, faces)
        if spp_batch:
            pix = pids.repeat_interleave(spp)
            smp = torch.arange(spp, dtype=torch.int64,
                               device=device).repeat(npix)
            rad, nrays = wavefront.sample_wavefront(
                arrays, camera, cfg, intersector, smp, pix, with_stats=True)
            acc = rad.reshape(npix, spp, 3).sum(dim=1)
        else:
            acc, nrays = wavefront.sample_sum(arrays, camera, cfg,
                                              intersector, pids, spp)
        with trace.span("spray.glue.accumulate"):
            img = (acc[inv] * (1.0 / spp)).reshape(camera.height,
                                                   camera.width, 3)
        return (img, nrays) if with_stats else img

    render.base_intersector = base_intersector
    return render


def render_grad(scene, camera, cfg, params, loss_fn=None,
                make_intersector=None, device=None):
    """(loss, grads) of loss_fn(image) (default: the mean) w.r.t. every
    tensor in params."""
    if loss_fn is None:
        loss_fn = torch.mean
    render = make_diff_render_fn(scene, camera, cfg, make_intersector,
                                 device=device)
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(render(p))
    return loss.detach(), grads_of(loss, p)


def grads_of(loss, params):
    """{name: d loss / d params[name]}, zeros where the loss does not depend
    on a param (e.g. vertices under AO, pure visibility), as jax.grad
    gives."""
    if not loss.requires_grad:
        return {k: torch.zeros_like(v) for k, v in params.items()}
    g = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                            materialize_grads=True)
    return dict(zip(params, g))
