"""Wavefront integrators in torch: counterpart of
``spray_tpu/integrators/wavefront.py``.

Every bounce is one batched intersect + one batched shade over all lanes,
dead lanes masked, with the same ops, order and RNG streams as the
reference, so images agree with it to float tolerance.  The bounce loop is a
plain Python loop (the reference's `_path_trace_scan` gives the same image
bit for bit as its loop form).

Integrators: "pt" (Lambertian path tracing with next-event estimation),
"ao" (primary visibility + ambient occlusion) and "normal" (debug view).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import geom, rng

INV_PI = 1.0 / math.pi


def scene_offset_eps(scene):
    """Self-intersection offset scaled to the scene's diagonal (host-side)."""
    v = np.asarray(scene.vertices)
    diag = float(np.linalg.norm(v.max(0) - v.min(0))) if len(v) else 1.0
    return np.float32(max(diag, 1e-6) * 1e-4)


def pgather(table, idx):
    """Rows table[idx] of a parameter table, -1 reading the last row as
    indexing does, with a deterministic backward (`geom.gather_rows`)."""
    idx = idx.long()
    return geom.gather_rows(table, torch.where(idx < 0, idx + table.shape[0], idx))


def _shade_prep(o, d, hits, normals, eps):
    """Hit point (offset along the facing normal) + facing normal.  Miss
    lanes get a benign finite t (1.0); their values are masked downstream."""
    n = pgather(normals, hits.prim)
    sgn = torch.where(geom.dot(n, d) < 0, 1.0, -1.0).to(n.dtype)
    n = n * sgn[..., None]
    t_safe = torch.where(hits.valid, hits.t, torch.ones_like(hits.t))
    p = o + t_safe[..., None] * d + n * eps
    return p, n


def _masked(mask, x):
    return torch.where(mask[..., None], x, torch.zeros_like(x))


def sample_wavefront(scene_arrays, camera, cfg, intersector, sample_idx,
                     pixel_ids, with_stats=False):
    """Render ONE sample for int64 flat pixel ids.  Returns (N, 3) radiance,
    or (radiance, rays_traced) with with_stats: the count of lanes with a
    nonzero trace window per intersect/occluded call."""
    albedo = scene_arrays["albedo"]
    normals = scene_arrays["normals"]
    eps = float(scene_arrays["offset_eps"])
    dev = pixel_ids.device
    n = pixel_ids.shape[0]
    background = torch.tensor(cfg.background, dtype=torch.float32, device=dev)

    jx = rng.uniform(cfg.seed, pixel_ids, sample_idx, rng.dim_id(0, rng.PIXEL_JITTER, 0))
    jy = rng.uniform(cfg.seed, pixel_ids, sample_idx, rng.dim_id(0, rng.PIXEL_JITTER, 1))
    o, d = geom.camera_rays(camera, pixel_ids, jx, jy)

    if cfg.integrator == "pt":
        rad, nrays = _path_trace(
            o, d, pixel_ids, sample_idx, albedo, scene_arrays["emission"],
            normals, eps, background, cfg, intersector,
            scene_arrays.get("lights"),
        )
    elif cfg.integrator == "ao":
        rad, nrays = _ambient_occlusion(
            o, d, pixel_ids, sample_idx, albedo, normals, eps, background,
            cfg, intersector,
        )
    elif cfg.integrator == "normal":
        tmin = torch.zeros(n, dtype=torch.float32, device=dev)
        tmax = torch.full((n,), geom.INF, dtype=torch.float32, device=dev)
        hits = intersector.intersect(o, d, tmin, tmax)
        _, nrm = _shade_prep(o, d, hits, normals, eps)
        col = nrm * 0.5 + 0.5
        rad = torch.where(hits.valid[..., None], col, background)
        nrays = n
    else:
        raise ValueError(f"unknown integrator {cfg.integrator!r}")
    return (rad, nrays) if with_stats else rad


def _sample_light_point(lights, u_pick, u1, u2):
    """Point on the light set, uniform tri pick.  Returns
    (y, ny, Le, pdf_weight)."""
    num = lights["v0"].shape[0]
    idx = torch.clamp((u_pick * float(num)).to(torch.int64), max=num - 1)
    su = torch.sqrt(u1)
    b1 = (su * (1.0 - u2))[..., None]
    b2 = (su * u2)[..., None]
    y = (pgather(lights["v0"], idx) + b1 * pgather(lights["e1"], idx)
         + b2 * pgather(lights["e2"], idx))
    weight = pgather(lights["area"], idx) * float(num)
    return y, pgather(lights["normal"], idx), pgather(lights["Le"], idx), weight


def _path_trace(o, d, pixel_ids, sample_idx, albedo, emission, normals, eps,
                background, cfg, intersector, lights=None):
    dev = o.device
    n = pixel_ids.shape[0]
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    tmin = torch.zeros(n, dtype=torch.float32, device=dev)
    tmax = torch.full((n,), geom.INF, dtype=torch.float32, device=dev)
    nee = cfg.nee and lights is not None
    # actual trace activations (lanes with a nonzero window)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)

    for bounce in range(cfg.bounces + 1):
        win = torch.where(alive, tmax, torch.zeros_like(tmax))
        nrays = nrays + alive.sum()
        hits = intersector.intersect(o, d, tmin, win)
        prim = hits.prim.long()
        hit = alive & hits.valid
        miss = alive & ~hits.valid
        radiance = radiance + _masked(miss, throughput * background)
        if not nee or bounce == 0:
            # with NEE, emission after the first hit is counted by the light
            # samples
            radiance = radiance + _masked(hit, throughput * pgather(emission, prim))
        if bounce == cfg.bounces:
            break
        p, nrm = _shade_prep(o, d, hits, normals, eps)
        if nee:
            u_pick = rng.uniform(cfg.seed, pixel_ids, sample_idx,
                                 rng.dim_id(bounce, rng.LIGHT, 0))
            lu1 = rng.uniform(cfg.seed, pixel_ids, sample_idx,
                              rng.dim_id(bounce, rng.LIGHT, 1))
            lu2 = rng.uniform(cfg.seed, pixel_ids, sample_idx,
                              rng.dim_id(bounce, rng.LIGHT, 2))
            y, ny, le, pick_w = _sample_light_point(lights, u_pick, lu1, lu2)
            wi_raw = y - p
            d2 = geom.dot(wi_raw, wi_raw)
            dist = torch.sqrt(torch.clamp(d2, min=1e-12))
            wi = wi_raw / dist[..., None]
            cos_s = geom.dot(nrm, wi)
            cos_l = -geom.dot(ny, wi)
            front = hit & (cos_s > 0) & (cos_l > 0)
            nrays = nrays + front.sum()
            occ = intersector.occluded(
                p, wi, torch.where(front, dist * (1.0 - 1e-3), torch.zeros_like(dist))
            )
            geo = cos_s * cos_l / torch.clamp(d2, min=1e-12) * pick_w
            contrib = (throughput * pgather(albedo, prim) * INV_PI * le
                       * geo[..., None])
            radiance = radiance + _masked(front & ~occ, contrib)
        u1, u2 = rng.uniform2(cfg.seed, pixel_ids, sample_idx, bounce, rng.BSDF)
        local = geom.cosine_hemisphere(u1, u2)
        new_d = geom.local_to_world(local, nrm)
        throughput = throughput * torch.where(
            hit[..., None], pgather(albedo, prim), torch.ones_like(throughput))
        alive = hit & (throughput.amax(dim=-1) > 0.0)
        o = torch.where(hit[..., None], p, o)
        d = torch.where(hit[..., None], new_d, d)
    return radiance, nrays


def _ambient_occlusion(o, d, pixel_ids, sample_idx, albedo, normals, eps,
                       background, cfg, intersector):
    dev = o.device
    n = pixel_ids.shape[0]
    tmin = torch.zeros(n, dtype=torch.float32, device=dev)
    tmax = torch.full((n,), geom.INF, dtype=torch.float32, device=dev)
    hits = intersector.intersect(o, d, tmin, tmax)
    nrays = n + cfg.ao_samples * hits.valid.sum()
    p, nrm = _shade_prep(o, d, hits, normals, eps)
    vis = torch.zeros(n, dtype=torch.float32, device=dev)
    radius = torch.where(hits.valid, cfg.ao_radius, 0.0).to(torch.float32)
    for k in range(cfg.ao_samples):
        u1 = rng.uniform(cfg.seed, pixel_ids, sample_idx, rng.dim_id(k, rng.AO, 0))
        u2 = rng.uniform(cfg.seed, pixel_ids, sample_idx, rng.dim_id(k, rng.AO, 1))
        ao_d = geom.local_to_world(geom.cosine_hemisphere(u1, u2), nrm)
        occ = intersector.occluded(p, ao_d, radius)
        vis = vis + torch.where(occ, 0.0, 1.0)
    vis = vis * (1.0 / max(cfg.ao_samples, 1))
    col = pgather(albedo, hits.prim) * vis[..., None]
    return torch.where(hits.valid[..., None], col, background), nrays


def light_ids_static(scene):
    """Face ids of emissive triangles (host-side)."""
    em = np.asarray(scene.emission)
    return np.nonzero(em.max(axis=1) > 0)[0].astype(np.int64)


def make_light_arrays(vertices, faces, emission, light_ids):
    """Light-sampling SoA from scene tensors; None without emissive faces."""
    if len(light_ids) == 0:
        return None
    lid = torch.as_tensor(light_ids, device=vertices.device)
    f = faces[lid].long()
    tv = pgather(vertices, f.reshape(-1)).reshape(-1, 3, 3)
    v0 = tv[:, 0]
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    nvec = geom.cross(e1, e2)
    nlen = torch.sqrt(geom.dot(nvec, nvec))
    area = 0.5 * nlen
    normal = nvec / torch.clamp(nlen, min=1e-12)[..., None]
    return {"v0": v0, "e1": e1, "e2": e2, "normal": normal,
            "Le": pgather(emission, lid), "area": area}


def make_scene_arrays(scene, device):
    """Per-face shading arrays on `device`.  Normals are computed on the
    CPU, as the reference computes them in numpy, so every device consumes
    the same values."""
    def t(x, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(x, dtype), device=device)

    normals = geom.face_normals(
        torch.as_tensor(np.asarray(scene.vertices, np.float32)),
        torch.as_tensor(np.asarray(scene.faces, np.int64)),
    )
    emission = t(scene.emission)
    return {
        "albedo": t(scene.albedo),
        "emission": emission,
        "normals": normals.to(device),
        "offset_eps": scene_offset_eps(scene),
        "lights": make_light_arrays(t(scene.vertices), t(scene.faces, np.int64),
                                    emission, light_ids_static(scene)),
    }


def render(scene, camera, cfg, intersector, device, pixel_chunk=None):
    """Full frame, one wavefront per sample in plain pixel order (cut into
    wavefronts of `pixel_chunk` pixels if given), averaged over cfg.spp:
    the eager loop of host-driven intersectors (the out-of-core scheduler)
    and of the oracle.  Returns the (H, W, 3) image tensor."""
    npix = camera.width * camera.height
    chunk = pixel_chunk or npix
    scene_arrays = make_scene_arrays(scene, device)
    acc = torch.zeros((npix, 3), dtype=torch.float32, device=device)
    for s in range(cfg.spp):
        for c0 in range(0, npix, chunk):
            ids = torch.arange(c0, min(c0 + chunk, npix), dtype=torch.int64,
                               device=device)
            acc[c0:c0 + ids.shape[0]] += sample_wavefront(
                scene_arrays, camera, cfg, intersector, s, ids)
    img = acc * (1.0 / cfg.spp)
    return img.reshape(camera.height, camera.width, 3)
