"""Procedural example scenes + mesh utilities: numpy copies of
``spray_tpu/io/scenes.py``.  With the same seed they give byte-identical
arrays.  All host-side numpy; float32.

Scenes double as test fixtures and benchmark inputs:
  - cornell_box: BASELINE.md config 1 (few hundred tris).
  - icosphere / bumpy_sphere: ~100K-tri single mesh, config 2.
  - wisp_cloud: many-blob scene scalable to 1M+ tris for configs 3-5; its
    spatial clustering makes it a natural domain-decomposition fixture, like
    the reference's synthetic wisp scenes.
"""

from __future__ import annotations

import numpy as np

from ..core.types import Scene


def _scene(verts, faces, albedo, emission):
    return Scene(
        vertices=np.asarray(verts, np.float32),
        faces=np.asarray(faces, np.int32),
        albedo=np.asarray(albedo, np.float32),
        emission=np.asarray(emission, np.float32),
    )


def merge_scenes(scenes):
    verts, faces, albedo, emission = [], [], [], []
    off = 0
    for s in scenes:
        verts.append(s.vertices)
        faces.append(s.faces + off)
        albedo.append(s.albedo)
        emission.append(s.emission)
        off += s.vertices.shape[0]
    return _scene(
        np.concatenate(verts), np.concatenate(faces),
        np.concatenate(albedo), np.concatenate(emission),
    )


def quad(p0, p1, p2, p3, albedo, emission=(0, 0, 0)):
    """Two-triangle quad; vertices counter-clockwise."""
    verts = np.array([p0, p1, p2, p3], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    a = np.tile(np.asarray(albedo, np.float32), (2, 1))
    e = np.tile(np.asarray(emission, np.float32), (2, 1))
    return _scene(verts, faces, a, e)


def box(lo, hi, albedo):
    """Axis-aligned box (12 tris), outward normals."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    quads = [
        # floor (y0, normal +y is inward for room use; normals are two-sided)
        ([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),
        ([x0, y1, z0], [x0, y1, z1], [x1, y1, z1], [x1, y1, z0]),  # ceiling
        ([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),  # left
        ([x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1]),  # right
        ([x0, y0, z0], [x0, y1, z0], [x1, y1, z0], [x1, y0, z0]),  # back
        ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),  # front
    ]
    return merge_scenes([quad(*q, albedo) for q in quads])


def cornell_box():
    """Classic Cornell box in [0,1]^3, camera looks down -z; emissive ceiling
    panel (36 tris total).  BASELINE.md config 1 fixture."""
    white = (0.73, 0.73, 0.73)
    red = (0.65, 0.05, 0.05)
    green = (0.12, 0.45, 0.15)
    parts = [
        quad([0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1], white),  # floor
        quad([0, 1, 0], [0, 1, 1], [1, 1, 1], [1, 1, 0], white),  # ceiling
        quad([0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0], red),  # left wall
        quad([1, 0, 0], [1, 1, 0], [1, 1, 1], [1, 0, 1], green),  # right wall
        quad([0, 0, 0], [0, 1, 0], [1, 1, 0], [1, 0, 0], white),  # back wall
        # light panel slightly below ceiling
        quad(
            [0.35, 0.999, 0.35], [0.65, 0.999, 0.35],
            [0.65, 0.999, 0.65], [0.35, 0.999, 0.65],
            (0.0, 0.0, 0.0), emission=(15.0, 15.0, 15.0),
        ),
        # two interior boxes (lifted 1e-3 off the floor: exactly-coplanar
        # faces create t-ties that different-but-correct intersectors break
        # differently, poisoning image-equality oracles)
        box([0.12, 0.001, 0.45], [0.42, 0.6, 0.75], white),
        box([0.55, 0.001, 0.15], [0.85, 0.3, 0.45], white),
    ]
    return merge_scenes(parts)


def icosphere(subdiv=3, center=(0, 0, 0), radius=1.0, albedo=(0.7, 0.7, 0.7)):
    """Icosphere via loop subdivision: 20 * 4**subdiv triangles."""
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
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        mid_idx = len(v) + np.arange(len(uniq))
        v = np.concatenate([v, mid])
        n = len(f)
        m01, m12, m20 = (
            mid_idx[inv[0:n]], mid_idx[inv[n : 2 * n]], mid_idx[inv[2 * n :]]
        )
        f = np.concatenate(
            [
                np.stack([f[:, 0], m01, m20], 1),
                np.stack([f[:, 1], m12, m01], 1),
                np.stack([f[:, 2], m20, m12], 1),
                np.stack([m01, m12, m20], 1),
            ]
        )
    verts = (np.asarray(center, np.float64) + radius * v).astype(np.float32)
    nf = len(f)
    return _scene(
        verts, f.astype(np.int32),
        np.tile(np.asarray(albedo, np.float32), (nf, 1)),
        np.zeros((nf, 3), np.float32),
    )


def bumpy_sphere(subdiv=5, center=(0, 0, 0), radius=1.0, bump=0.08, seed=7,
                 albedo=(0.7, 0.6, 0.5)):
    """~100K-tri displaced sphere (subdiv=6 → 81920*4=... 20*4^6 = 81920 tris;
    subdiv=6 gives 81920, subdiv=7 gives 327K).  Config-2 class fixture."""
    s = icosphere(subdiv, (0, 0, 0), 1.0, albedo)
    rng = np.random.RandomState(seed)
    freqs = rng.uniform(2.0, 6.0, size=(4, 3)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, size=(4,)).astype(np.float32)
    v = s.vertices
    disp = np.zeros(len(v), np.float32)
    for k in range(4):
        disp += np.sin(v @ freqs[k] * 3.0 + phases[k]) / (k + 1)
    v = v * (1.0 + bump * disp)[:, None]
    v = (np.asarray(center, np.float32) + radius * v).astype(np.float32)
    return _scene(v, s.faces, s.albedo, s.emission)


def wisp_cloud(n_blobs=64, tris_per_blob=2048, extent=8.0, seed=3,
               emissive_frac=0.05, layout="grid"):
    """Clustered blob scene: n_blobs displaced spheres scattered in a cube of
    half-extent `extent`, plus a ground plane.  Natural fixture for domain
    decomposition (blobs cluster spatially).  64 blobs x ~16K tris ≈ 1M tris.
    """
    rng = np.random.RandomState(seed)
    # subdiv chosen to get >= tris_per_blob
    subdiv = max(0, int(np.ceil(np.log(tris_per_blob / 20.0) / np.log(4.0))))
    parts = []
    side = int(np.ceil(n_blobs ** (1.0 / 3.0)))
    emissive = rng.uniform(size=n_blobs) < emissive_frac
    if emissive_frac > 0 and not emissive.any():
        emissive[0] = True  # guarantee a light: a lightless PT bench is hollow
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
        s = bumpy_sphere(
            subdiv, center, radius, bump=0.15, seed=seed + i, albedo=albedo
        )
        if emissive[i]:
            em = np.tile(rng.uniform(2, 8, 3).astype(np.float32), (s.num_faces, 1))
            s = _scene(s.vertices, s.faces, s.albedo, em)
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
