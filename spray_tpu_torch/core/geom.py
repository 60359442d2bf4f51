"""Geometry + sampling math in torch, with the op order of
``spray_tpu/core/geom.py`` so the port and the reference round alike.

float32 everywhere; vectors are trailing-(3,) tensors; all functions
broadcast over leading dims.  Dot products are written out term by term
(((x0*y0) + x1*y1) + x2*y2), the order numpy and XLA use for a 3-term sum.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-7
INF = float("inf")
TWO_PI = 2.0 * math.pi


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def normalize(v):
    return v / torch.sqrt(dot(v, v))[..., None]


def make_onb(n):
    """Branchless orthonormal basis around unit normal n (Duff et al. 2017)."""
    nz = n[..., 2]
    sign = torch.where(nz >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        dim=-1,
    )
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def cosine_hemisphere(u1, u2):
    """Cosine-weighted direction in the local frame from two uniforms."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return torch.stack([x, y, z], dim=-1)


def local_to_world(local_dir, n):
    t, bt = make_onb(n)
    return local_dir[..., 0:1] * t + local_dir[..., 1:2] * bt + local_dir[..., 2:3] * n


def camera_rays(camera, pixel_ids, jx, jy):
    """Primary rays for int64 flat pixel ids with sub-pixel jitter (jx, jy).

    Pixel p maps to (p % W, p // W); row 0 is the top of the image.
    """
    dev = pixel_ids.device
    w = camera.width
    px = (pixel_ids % w).to(torch.float32) + jx
    py = (pixel_ids // w).to(torch.float32) + jy
    py = float(camera.height) - py
    eye = torch.as_tensor(camera.eye, dtype=torch.float32, device=dev)
    lower_left = torch.as_tensor(camera.lower_left, dtype=torch.float32, device=dev)
    du = torch.as_tensor(camera.du, dtype=torch.float32, device=dev)
    dv = torch.as_tensor(camera.dv, dtype=torch.float32, device=dev)
    target = lower_left + px[..., None] * du + py[..., None] * dv
    d = normalize(target - eye)
    o = eye.expand(d.shape).contiguous()
    return o, d


def moller_trumbore(ro, rd, v0, e1, e2):
    """Möller–Trumbore ray/triangle test, broadcasting over leading dims.

    Returns (t, u, v, hit_mask); t is +inf where the test misses.
    """
    pvec = cross(rd, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) > EPS
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = ro - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(rd, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    t = torch.where(ok, t, torch.full_like(t, INF))
    return t, u, v, ok


def face_normals(verts, faces):
    """(F, 3) geometric unit normals.  The vertex gather is index_select,
    whose backward adds with atomics (see integrators.wavefront.pgather)."""
    tv = torch.index_select(verts, 0, faces.reshape(-1).long())
    tv = tv.reshape(faces.shape[0], 3, 3)
    return normalize(cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))


def ray_aabb(ro_inv_o, inv_d, lo, hi, tmin, tmax):
    """Slab test.  ro_inv_o = ro * inv_d (precomputed); returns (t_entry, hit).

    lo/hi: (..., 3) box corners.  Robust to inf*0 via min/max ordering.
    """
    t0 = lo * inv_d - ro_inv_o
    t1 = hi * inv_d - ro_inv_o
    tlo = torch.minimum(t0, t1)
    thi = torch.maximum(t0, t1)
    t_entry = torch.maximum(tlo.amax(dim=-1), tmin)
    t_exit = torch.minimum(thi.amin(dim=-1), tmax)
    return t_entry, t_entry <= t_exit
