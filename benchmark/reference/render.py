"""The plain reference renderer: the deployments' pinhole camera,
Lambertian path tracing with next-event estimation, and its gradients, in
plain PyTorch over `BoxCullIntersector`.

It takes the scene's arrays and the camera as the benchmark made them and
works out everything else again: triangle tests, normals, lights, paths.
The differentiable form holds visibility (which triangle a ray hits,
whether a shadow ray is blocked) fixed and takes the exact gradient of the
shading and geometry of that configuration: the hit distance is the
Möller–Trumbore distance of the hit triangle's live vertices, and normals
and light samples are built from the live vertices.

`Reference(scene, device, dtype)` holds the scene on the device in one
dtype: float32 for the reference, a lower one for its control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from .intersect import BoxCullIntersector, cross, dot, moller_trumbore

INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi


def make_camera(eye, lookat, up, fov_y_deg, width, height):
    """Pinhole camera basis (float32 numpy): eye, lower_left, du, dv."""
    eye = np.asarray(eye, np.float32)
    lookat = np.asarray(lookat, np.float32)
    up = np.asarray(up, np.float32)
    fwd = lookat - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    vup = np.cross(right, fwd)
    half_h = np.tan(np.radians(fov_y_deg) * 0.5)
    half_w = half_h * (width / height)
    du = (2.0 * half_w / width) * right
    dv = (2.0 * half_h / height) * vup
    lower_left = eye + fwd - half_w * right - half_h * vup
    return {"eye": eye.astype(np.float32),
            "lower_left": lower_left.astype(np.float32),
            "du": du.astype(np.float32), "dv": dv.astype(np.float32),
            "width": int(width), "height": int(height)}


def normalize(v):
    return v / torch.sqrt(dot(v, v))[..., None]


def rows(table, idx):
    """table[idx], -1 reading the last row."""
    idx = idx.long()
    return torch.index_select(
        table, 0, torch.where(idx < 0, idx + table.shape[0], idx).reshape(-1)
    ).reshape(idx.shape + table.shape[1:])


def face_normals(verts, faces):
    tv = rows(verts, faces.reshape(-1)).reshape(-1, 3, 3)
    return normalize(cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))


def light_arrays(verts, faces, emission, light_ids):
    if light_ids.numel() == 0:
        return None
    tv = rows(verts, faces[light_ids].reshape(-1)).reshape(-1, 3, 3)
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    nvec = cross(e1, e2)
    nlen = torch.sqrt(dot(nvec, nvec))
    return {"v0": tv[:, 0], "e1": e1, "e2": e2, "area": 0.5 * nlen,
            "normal": nvec / torch.clamp(nlen, min=1e-12)[..., None],
            "Le": rows(emission, light_ids)}


def cosine_hemisphere(u1, u2):
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def local_to_world(local, n):
    nz = n[..., 2]
    sign = torch.where(nz >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return local[..., 0:1] * t + local[..., 1:2] * bt + local[..., 2:3] * n


class Reference:
    """The scene on `device` in `dtype`, with its intersector."""

    def __init__(self, scene, device, dtype=torch.float32):
        v = np.asarray(scene["vertices"], np.float32)
        diag = float(np.linalg.norm(v.max(0) - v.min(0))) if len(v) else 1.0
        self.eps = float(np.float32(max(diag, 1e-6) * 1e-4))
        self.device = torch.device(device)
        self.dtype = dtype

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=self.device).to(dtype)

        self.vertices = t(scene["vertices"])
        self.albedo = t(scene["albedo"])
        self.emission = t(scene["emission"])
        self.faces = torch.as_tensor(np.asarray(scene["faces"], np.int64),
                                     device=self.device)
        em = np.asarray(scene["emission"])
        self.light_ids = torch.as_tensor(
            np.nonzero(em.max(axis=1) > 0)[0].astype(np.int64),
            device=self.device)
        self.isect = BoxCullIntersector(self.vertices, self.faces)

    def _hits(self, verts, o, d, tmax, live):
        """(t, prim, valid) of the nearest hits of the `live` rays; t is the
        Möller–Trumbore distance to the hit triangle's live vertices."""
        n = o.shape[0]
        idx = torch.nonzero(live).reshape(-1)
        prim = torch.full((n,), -1, dtype=torch.int64, device=o.device)
        t_found = tmax.detach().clone()
        if idx.numel():
            tf, pf = self.isect.intersect(
                o[idx].detach(), d[idx].detach(),
                torch.zeros_like(tmax[idx]), tmax[idx].detach())
            prim[idx] = pf
            t_found[idx] = tf
        valid = prim >= 0
        tv = rows(verts, self.faces[torch.clamp(prim, min=0)].reshape(-1))
        tv = tv.reshape(-1, 3, 3)
        t, ok = moller_trumbore(o, d, tv[:, 0], tv[:, 1] - tv[:, 0],
                                tv[:, 2] - tv[:, 0])
        return torch.where(valid & ok, t, t_found), prim, valid

    def _occluded(self, o, d, tmax):
        n = o.shape[0]
        idx = torch.nonzero(tmax > 0).reshape(-1)
        occ = torch.zeros(n, dtype=torch.bool, device=o.device)
        if idx.numel():
            occ[idx] = self.isect.occluded(o[idx].detach(), d[idx].detach(),
                                           tmax[idx].detach())
        return occ

    def paths(self, cam, cfg, pix, smp, verts=None, albedo=None):
        """Radiance (N, 3) of the paths of (pixel, sample) pairs, and the
        count of traced rays.  verts / albedo: live parameter tensors for
        gradients (default: the scene's)."""
        verts = self.vertices if verts is None else verts
        albedo = self.albedo if albedo is None else albedo
        dt, dev = self.dtype, self.device
        seed = int(cfg["seed"])
        normals = face_normals(verts, self.faces)
        lights = (light_arrays(verts, self.faces, self.emission,
                               self.light_ids) if cfg["nee"] else None)

        def uni(dim):
            return rng.uniform(seed, pix, smp, dim).to(dt)

        w = cam["width"]
        jx = uni(rng.dim_id(0, rng.PIXEL_JITTER, 0))
        jy = uni(rng.dim_id(0, rng.PIXEL_JITTER, 1))
        px = (pix % w).to(dt) + jx
        py = float(cam["height"]) - ((pix // w).to(dt) + jy)

        def vec(k):
            return torch.as_tensor(cam[k], device=dev).to(dt)

        target = (vec("lower_left") + px[..., None] * vec("du")
                  + py[..., None] * vec("dv"))
        d = normalize(target - vec("eye"))
        o = vec("eye").expand(d.shape).contiguous()
        n = pix.shape[0]
        background = torch.tensor(cfg["background"], dtype=dt, device=dev)
        radiance = torch.zeros((n, 3), dtype=dt, device=dev)
        throughput = torch.ones((n, 3), dtype=dt, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        inf = torch.full((n,), float("inf"), dtype=dt, device=dev)
        nee = lights is not None
        nrays = 0
        zeros3 = torch.zeros_like(radiance)
        for bounce in range(cfg["bounces"] + 1):
            nrays += int(alive.sum())
            t, prim, valid = self._hits(verts, o, d, inf, alive)
            hit = alive & valid
            miss = alive & ~valid
            radiance = radiance + torch.where(miss[:, None],
                                              throughput * background, zeros3)
            if not nee or bounce == 0:
                radiance = radiance + torch.where(
                    hit[:, None], throughput * rows(self.emission, prim), zeros3)
            if bounce == cfg["bounces"]:
                break
            nrm = rows(normals, prim)
            sgn = torch.where(dot(nrm, d) < 0, 1.0, -1.0).to(dt)
            nrm = nrm * sgn[:, None]
            t_safe = torch.where(hit, t, torch.ones_like(t))
            p = o + t_safe[:, None] * d + nrm * self.eps
            if nee:
                u_pick = uni(rng.dim_id(bounce, rng.LIGHT, 0))
                lu1 = uni(rng.dim_id(bounce, rng.LIGHT, 1))
                lu2 = uni(rng.dim_id(bounce, rng.LIGHT, 2))
                num = lights["v0"].shape[0]
                li = torch.clamp((u_pick * float(num)).to(torch.int64),
                                 max=num - 1)
                su = torch.sqrt(lu1)
                b1 = (su * (1.0 - lu2))[:, None]
                b2 = (su * lu2)[:, None]
                y = (rows(lights["v0"], li) + b1 * rows(lights["e1"], li)
                     + b2 * rows(lights["e2"], li))
                wi_raw = y - p
                d2 = dot(wi_raw, wi_raw)
                dist = torch.sqrt(torch.clamp(d2, min=1e-12))
                wi = wi_raw / dist[:, None]
                cos_s = dot(nrm, wi)
                cos_l = -dot(rows(lights["normal"], li), wi)
                front = hit & (cos_s > 0) & (cos_l > 0)
                nrays += int(front.sum())
                occ = self._occluded(p, wi, torch.where(
                    front, dist * (1.0 - 1e-3), torch.zeros_like(dist)))
                geo = (cos_s * cos_l / torch.clamp(d2, min=1e-12)
                       * (rows(lights["area"], li) * float(num)))
                contrib = (throughput * rows(albedo, prim) * INV_PI
                           * rows(lights["Le"], li) * geo[:, None])
                radiance = radiance + torch.where((front & ~occ)[:, None],
                                                  contrib, zeros3)
            u1 = uni(rng.dim_id(bounce, rng.BSDF, 0))
            u2 = uni(rng.dim_id(bounce, rng.BSDF, 1))
            new_d = local_to_world(cosine_hemisphere(u1, u2), nrm)
            throughput = throughput * torch.where(
                hit[:, None], rows(albedo, prim), torch.ones_like(throughput))
            alive = hit & (throughput.amax(dim=-1) > 0.0)
            o = torch.where(hit[:, None], p, o)
            d = torch.where(hit[:, None], new_d, d)
        return radiance, nrays

    def pixels(self, cam, cfg, pixel_ids, block=1 << 18):
        """(K, 3) float32 values of the frame's pixels `pixel_ids`: the mean
        of their spp paths."""
        spp = int(cfg["spp"])
        out = []
        with torch.no_grad():
            for k0 in range(0, pixel_ids.shape[0], max(1, block // spp)):
                ids = pixel_ids[k0:k0 + max(1, block // spp)]
                pix = ids.repeat_interleave(spp)
                smp = torch.arange(spp, device=ids.device).repeat(ids.shape[0])
                rad, _ = self.paths(cam, cfg, pix, smp)
                acc = rad.reshape(-1, spp, 3).sum(dim=1)
                out.append((acc * (1.0 / spp)).float())
        return torch.cat(out)

    def loss_and_grads(self, cam, cfg, weights, block=1 << 18):
        """loss = mean over the whole image of image * weights, and its
        gradients {vertices, albedo}, in blocks of pixels."""
        spp = int(cfg["spp"])
        npix = cam["width"] * cam["height"]
        verts = self.vertices.clone().requires_grad_(True)
        albedo = self.albedo.clone().requires_grad_(True)
        w = torch.tensor(weights, dtype=self.dtype, device=self.device)
        loss = 0.0
        per = max(1, block // spp)
        for k0 in range(0, npix, per):
            ids = torch.arange(k0, min(npix, k0 + per), device=self.device)
            pix = ids.repeat_interleave(spp)
            smp = torch.arange(spp, device=self.device).repeat(ids.shape[0])
            rad, _ = self.paths(cam, cfg, pix, smp, verts, albedo)
            img = rad.reshape(-1, spp, 3).sum(dim=1) * (1.0 / spp)
            part = (img * w).sum() / (npix * 3)
            part.backward()
            loss += float(part.detach())
        return loss, {"vertices": verts.grad.float(),
                      "albedo": albedo.grad.float()}
