"""Frozen render config: a copy of ``spray_tpu.core.config.RenderConfig``."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 256
    height: int = 256
    spp: int = 4  # samples per pixel
    bounces: int = 3  # path-tracing bounces (0 = primary visibility only)
    ao_samples: int = 8  # ambient-occlusion rays per shading point
    ao_radius: float = 1e30  # max AO occlusion distance
    seed: int = 0
    integrator: str = "pt"  # "pt" | "ao" | "normal"
    nee: bool = True  # next-event estimation (direct light sampling) in "pt"
    background: tuple = (0.0, 0.0, 0.0)
