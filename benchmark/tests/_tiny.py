"""A copy of the benchmark in a temporary directory, with every cell cut
to a size the CPU renders in a fraction of a second."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# half the blobs glow, so that most pixels of a tiny frame see light
TINY_SCENE = {"generator": "wisp_cloud", "n_blobs": 8, "tris_per_blob": 80,
              "seed": 3, "emissive_frac": 0.5}
TINY_CAMERA = {"eye": [9.0, 6.0, 11.0], "lookat": [0.0, 0.0, 0.0],
               "up": [0.0, 1.0, 0.0], "fov_y_deg": 45}


def tiny_copy(dst):
    """Copy BENCHMARK.json and benchmark/ under `dst`, cut to tiny sizes
    (the port's package is reached through sys.path): returns (root,
    manifest)."""
    dst = Path(dst)
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    manifest = json.loads((dst / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        path = dst / c["file"]
        cfg = json.loads(path.read_text())
        cfg["scene"] = dict(TINY_SCENE)
        cfg["camera"] = dict(TINY_CAMERA)
        opts = cfg["intersector"]["options"]
        if "n_domains" in opts:
            opts["n_domains"] = min(opts["n_domains"], 4)
        if "num_slots" in opts:
            opts["num_slots"] = 2
        path.write_text(json.dumps(cfg))
    for path in (dst / "benchmark" / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr["width"] = tr["height"] = 16
        path.write_text(json.dumps(tr))
    return dst, manifest
