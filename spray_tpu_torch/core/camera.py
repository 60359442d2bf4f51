"""Host-side pinhole camera construction (numpy copy of
``spray_tpu.core.camera.make_camera``)."""

from __future__ import annotations

import numpy as np

from .types import Camera


def make_camera(eye, lookat, up, fov_y_deg, width, height):
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

    # Image plane at unit distance along fwd; du/dv are per-pixel steps.
    du = (2.0 * half_w / width) * right
    dv = (2.0 * half_h / height) * vup
    lower_left = eye + fwd - half_w * right - half_h * vup

    return Camera(
        eye=eye.astype(np.float32),
        lower_left=lower_left.astype(np.float32),
        du=du.astype(np.float32),
        dv=dv.astype(np.float32),
        width=int(width),
        height=int(height),
    )
