"""Display layer (counterpart of ``spray_tpu/viewer``).

On a headless host:
  - `show_terminal`: ANSI truecolor half-block preview straight in the tty,
    the practical live view of a remote session;
  - `InteractiveViewer`: progressive renderer loop that re-renders on camera
    orbit commands and writes/streams frames (file-watch or notebook use);
  - GLFW, when a display + glfw module exist, via `show_glfw` (optional,
    degrades gracefully — the reference's viewer is also optional at build
    time).
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.image import tonemap


def show_terminal(img, max_width=100, out=sys.stdout):
    """ANSI truecolor preview using half blocks (2 pixels per char row)."""
    u8 = tonemap(img)
    h, w, _ = u8.shape
    scale = max(1, int(np.ceil(w / max_width)))
    u8 = u8[::scale, ::scale]
    h, w, _ = u8.shape
    if h % 2:
        u8 = np.concatenate([u8, np.zeros((1, w, 3), np.uint8)])
        h += 1
    lines = []
    for y in range(0, h, 2):
        row = []
        for x in range(w):
            tr, tg, tb = u8[y, x]
            br, bg, bb = u8[y + 1, x]
            row.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
            )
        lines.append("".join(row) + "\x1b[0m")
    out.write("\n".join(lines) + "\n")
    out.flush()


def show_glfw(img, title="spray_tpu"):  # pragma: no cover - needs a display
    """Optional GLFW window (reference parity); raises if glfw is absent."""
    import glfw  # noqa: PLC0415
    from OpenGL import GL  # noqa: PLC0415

    if not glfw.init():
        raise RuntimeError("glfw init failed")
    h, w, _ = img.shape
    win = glfw.create_window(w, h, title, None, None)
    glfw.make_context_current(win)
    u8 = tonemap(img)[::-1]
    while not glfw.window_should_close(win):
        GL.glClear(GL.GL_COLOR_BUFFER_BIT)
        GL.glDrawPixels(w, h, GL.GL_RGB, GL.GL_UNSIGNED_BYTE, u8.tobytes())
        glfw.swap_buffers(win)
        glfw.poll_events()
    glfw.terminate()


class InteractiveViewer:
    """Progressive orbit viewer: accumulate spp over frames, orbit on demand.

    Usage:
        v = InteractiveViewer(scene, cfg)
        v.orbit(dtheta=0.2); v.frame()   # returns the accumulated image
    """

    def __init__(self, scene, cfg, size=256, intersector=None, device=None):
        from ..core.device import resolve_device  # noqa: PLC0415
        from ..render import default_intersector  # noqa: PLC0415

        self.device = resolve_device(device)
        self.scene = scene
        self.cfg = cfg
        self.size = size
        self.intersector = intersector or default_intersector(
            scene, device=self.device)
        v = np.asarray(scene.vertices)
        self.center = (v.min(0) + v.max(0)) / 2
        self.radius = float(np.linalg.norm(v.max(0) - v.min(0)))
        self.theta = 0.8
        self.phi = 0.35
        self._acc = None
        self._spp_done = 0

    def orbit(self, dtheta=0.0, dphi=0.0, zoom=1.0):
        self.theta += dtheta
        self.phi = float(np.clip(self.phi + dphi, -1.4, 1.4))
        self.radius *= zoom
        self._acc = None
        self._spp_done = 0

    def _camera(self):
        from ..core.camera import make_camera  # noqa: PLC0415

        eye = self.center + self.radius * np.asarray([
            np.cos(self.phi) * np.sin(self.theta),
            np.sin(self.phi),
            np.cos(self.phi) * np.cos(self.theta),
        ])
        return make_camera(
            eye=eye, lookat=self.center, up=(0, 1, 0), fov_y_deg=40,
            width=self.size, height=self.size,
        )

    def frame(self, spp=1):
        """Render `spp` more samples and return the running average."""
        import dataclasses  # noqa: PLC0415

        from ..integrators.device import render_device  # noqa: PLC0415

        cfg = dataclasses.replace(
            self.cfg, spp=spp, seed=self.cfg.seed + self._spp_done
        )
        img = render_device(self.scene, self._camera(), cfg, self.intersector,
                            device=self.device)
        if self._acc is None:
            self._acc = img * spp
        else:
            self._acc += img * spp
        self._spp_done += spp
        return self._acc / self._spp_done

    def show(self, spp=1, out=sys.stdout):
        show_terminal(self.frame(spp), out=out)
