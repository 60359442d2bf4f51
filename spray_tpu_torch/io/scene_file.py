"""Scene description files: a numpy copy of ``spray_tpu/io/scene_file.py``
(a scene is a list of domains, each with an AABB and a geometry file).

JSON format, one entry per domain:

    {
      "camera": {"eye": [..], "lookat": [..], "up": [..], "fov_y": 40},
      "domains": [
        {"mesh": "blob0.ply",          # path relative to the scene file
         "albedo":   [0.7, 0.7, 0.7],  # optional; PLY vertex colors win
         "emission": [0, 0, 0],        # optional
         "aabb": [[lo],[hi]]}          # optional; recomputed if absent
      ]
    }

`load_scene` returns (Scene, domain_assign, camera|None): the merged triangle
soup, the per-triangle domain id (the file-level decomposition — the in-situ
case where data is born decomposed), and the camera if present.
`save_scene` writes a Scene (+ optional partition) back out as PLY + JSON.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core.types import Scene
from ..core.camera import make_camera
from .ply import read_ply, write_ply


def load_scene(path):
    with open(path) as f:
        desc = json.load(f)
    base = os.path.dirname(os.path.abspath(path))
    verts, faces, albedo, emission, assign = [], [], [], [], []
    voff = 0
    for di, dom in enumerate(desc["domains"]):
        mesh = read_ply(os.path.join(base, dom["mesh"]))
        v, fc = mesh["vertices"], mesh["faces"]
        nf = len(fc)
        a = np.asarray(dom.get("albedo", (0.7, 0.7, 0.7)), np.float32)
        face_albedo = np.tile(a, (nf, 1))
        if mesh["colors"] is not None:
            # per-vertex colors -> per-face albedo (mean of corners)
            face_albedo = mesh["colors"][fc].mean(axis=1).astype(np.float32)
        e = np.asarray(dom.get("emission", (0, 0, 0)), np.float32)
        verts.append(v)
        faces.append(fc + voff)
        albedo.append(face_albedo)
        emission.append(np.tile(e, (nf, 1)))
        assign.append(np.full(nf, di, np.int32))
        voff += len(v)
    scene = Scene(
        vertices=np.concatenate(verts),
        faces=np.concatenate(faces),
        albedo=np.concatenate(albedo),
        emission=np.concatenate(emission),
    )
    camera = None
    if "camera" in desc:
        c = desc["camera"]
        camera = make_camera(
            eye=c["eye"], lookat=c["lookat"], up=c.get("up", (0, 1, 0)),
            fov_y_deg=c.get("fov_y", 40),
            width=c.get("width", 512), height=c.get("height", 512),
        )
    return scene, np.concatenate(assign), camera


def save_scene(path, scene, assign=None, camera=None):
    """Write scene as per-domain PLYs + a JSON description."""
    base = os.path.dirname(os.path.abspath(path))
    os.makedirs(base, exist_ok=True)
    verts = np.asarray(scene.vertices, np.float32)
    faces = np.asarray(scene.faces, np.int64)
    albedo = np.asarray(scene.albedo, np.float32)
    emission = np.asarray(scene.emission, np.float32)
    if assign is None:
        assign = np.zeros(len(faces), np.int32)
    stem = os.path.splitext(os.path.basename(path))[0]
    domains = []
    for d in np.unique(assign):
        sel = assign == d
        f = faces[sel]
        used = np.unique(f.reshape(-1))
        remap = np.zeros(len(verts), np.int64)
        remap[used] = np.arange(len(used))
        name = f"{stem}_d{int(d)}.ply"
        write_ply(os.path.join(base, name), verts[used], remap[f.reshape(-1)].reshape(-1, 3))
        tv = verts[used]
        domains.append({
            "mesh": name,
            "albedo": [float(x) for x in albedo[sel].mean(0)],
            "emission": [float(x) for x in emission[sel].mean(0)],
            "aabb": [[float(x) for x in tv.min(0)],
                     [float(x) for x in tv.max(0)]],
        })
    desc = {"domains": domains}
    if camera is not None:
        # camera stores a derived basis; persist the raw look-at parameters
        # only when provided as a dict {eye, lookat, up, fov_y, width, height}
        desc["camera"] = camera if isinstance(camera, dict) else None
        if desc["camera"] is None:
            del desc["camera"]
    with open(path, "w") as f:
        json.dump(desc, f, indent=1)
