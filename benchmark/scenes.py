"""The benchmark's own scene generators: a frozen copy of the procedural
scenes the deployments use (`wisp_cloud` and its helpers).

The benchmark makes every scene itself, so a change to the program's scene
code cannot move the yardstick.  A scene is a dict of host numpy arrays:
vertices (V, 3) float32, faces (F, 3) int32, albedo and emission (F, 3)
float32.  `wisp_cloud` gives the arrays of the program's generator of the
same name bit for bit (held by a test); it builds each icosphere once per
subdivision level, where the original rebuilt it for every blob.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np


def _scene(verts, faces, albedo, emission):
    return {
        "vertices": np.asarray(verts, np.float32),
        "faces": np.asarray(faces, np.int32),
        "albedo": np.asarray(albedo, np.float32),
        "emission": np.asarray(emission, np.float32),
    }


def merge_scenes(scenes):
    verts, faces, albedo, emission = [], [], [], []
    off = 0
    for s in scenes:
        verts.append(s["vertices"])
        faces.append(s["faces"] + off)
        albedo.append(s["albedo"])
        emission.append(s["emission"])
        off += s["vertices"].shape[0]
    return _scene(np.concatenate(verts), np.concatenate(faces),
                  np.concatenate(albedo), np.concatenate(emission))


def quad(p0, p1, p2, p3, albedo, emission=(0, 0, 0)):
    """Two-triangle quad; vertices counter-clockwise."""
    verts = np.array([p0, p1, p2, p3], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    a = np.tile(np.asarray(albedo, np.float32), (2, 1))
    e = np.tile(np.asarray(emission, np.float32), (2, 1))
    return _scene(verts, faces, a, e)


def icosphere_unit(subdiv):
    """Unit icosphere by loop subdivision: (float64 vertices, int64 faces),
    20 * 4**subdiv triangles."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        edges = np.sort(edges, axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        mid_idx = len(v) + np.arange(len(uniq))
        v = np.concatenate([v, mid])
        n = len(f)
        m01, m12, m20 = (mid_idx[inv[0:n]], mid_idx[inv[n:2 * n]],
                         mid_idx[inv[2 * n:]])
        f = np.concatenate([
            np.stack([f[:, 0], m01, m20], 1),
            np.stack([f[:, 1], m12, m01], 1),
            np.stack([f[:, 2], m20, m12], 1),
            np.stack([m01, m12, m20], 1),
        ])
    return v, f


def bumpy_sphere(unit, center, radius, bump, seed, albedo):
    """A displaced sphere from `unit` = icosphere_unit(subdiv)."""
    v64, f = unit
    # the unit sphere placed at the origin as float32 (0 + 1 * v, as the
    # original placed it: the sign of a zero coordinate is kept the same)
    v = (np.zeros(3) + 1.0 * v64).astype(np.float32)
    rng = np.random.RandomState(seed)
    freqs = rng.uniform(2.0, 6.0, size=(4, 3)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, size=(4,)).astype(np.float32)
    disp = np.zeros(len(v), np.float32)
    for k in range(4):
        disp += np.sin(v @ freqs[k] * 3.0 + phases[k]) / (k + 1)
    v = v * (1.0 + bump * disp)[:, None]
    v = (np.asarray(center, np.float32) + radius * v).astype(np.float32)
    nf = len(f)
    return _scene(v, f.astype(np.int32),
                  np.tile(np.asarray(albedo, np.float32), (nf, 1)),
                  np.zeros((nf, 3), np.float32))


def wisp_cloud(n_blobs=64, tris_per_blob=2048, extent=8.0, seed=3,
               emissive_frac=0.05, layout="grid"):
    """Clustered blob scene: n_blobs displaced spheres scattered in a cube of
    half-extent `extent`, plus a ground plane."""
    rng = np.random.RandomState(seed)
    subdiv = max(0, int(np.ceil(np.log(tris_per_blob / 20.0) / np.log(4.0))))
    unit = icosphere_unit(subdiv)
    parts = []
    side = int(np.ceil(n_blobs ** (1.0 / 3.0)))
    emissive = rng.uniform(size=n_blobs) < emissive_frac
    if emissive_frac > 0 and not emissive.any():
        emissive[0] = True  # guarantee a light
    for i in range(n_blobs):
        if layout == "grid":
            gx, gy, gz = i % side, (i // side) % side, i // (side * side)
            base = (np.array([gx, gy, gz], np.float32) + 0.5) / side
            center = (base * 2.0 - 1.0) * extent
            center += rng.uniform(-0.3, 0.3, 3) * extent / side
        else:
            center = rng.uniform(-extent, extent, 3)
        radius = rng.uniform(0.5, 1.2) * extent / side
        albedo = rng.uniform(0.2, 0.9, 3)
        s = bumpy_sphere(unit, center, radius, bump=0.15, seed=seed + i,
                         albedo=albedo)
        if emissive[i]:
            em = np.tile(rng.uniform(2, 8, 3).astype(np.float32),
                         (s["faces"].shape[0], 1))
            s = _scene(s["vertices"], s["faces"], s["albedo"], em)
        parts.append(s)
    ground = quad(
        [-2 * extent, -extent * 1.05, -2 * extent],
        [2 * extent, -extent * 1.05, -2 * extent],
        [2 * extent, -extent * 1.05, 2 * extent],
        [-2 * extent, -extent * 1.05, 2 * extent],
        (0.5, 0.5, 0.5),
    )
    parts.append(ground)
    return merge_scenes(parts)


GENERATORS = {"wisp_cloud": wisp_cloud}


def make_scene(spec, bench=Path(__file__).resolve().parent):
    """The scene of a configuration's `scene` entry: {"generator": name,
    **its keyword arguments}.  A generator not defined here is the
    `generate` function of `generators/<name>.py`."""
    kw = dict(spec)
    name = kw.pop("generator")
    if name in GENERATORS:
        return GENERATORS[name](**kw)
    path = bench / "generators" / f"{name}.py"
    spec_ = importlib.util.spec_from_file_location(f"benchmark_gen_{name}", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.generate(**kw)
