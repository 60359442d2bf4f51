"""Framebuffer helpers and image file output: a copy of
``spray_tpu/core/image.py``.  The framebuffer is a plain (H, W, 3) float32
numpy array; it is written as binary PPM, or PNG where pillow exists.
"""

from __future__ import annotations

import numpy as np


def tonemap(img, gamma=2.2):
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    return (255.0 * img ** (1.0 / gamma) + 0.5).astype(np.uint8)


def write_ppm(path, img, gamma=2.2):
    """img: (H, W, 3) float32 linear radiance in [0, 1]."""
    u8 = tonemap(img, gamma)
    h, w, _ = u8.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(u8.tobytes())


def write_image(path, img, gamma=2.2):
    path = str(path)
    if path.endswith(".ppm"):
        write_ppm(path, img, gamma)
        return
    try:
        from PIL import Image  # noqa: PLC0415

        Image.fromarray(tonemap(img, gamma)).save(path)
    except ImportError:
        write_ppm(path.rsplit(".", 1)[0] + ".ppm", img, gamma)
