"""The import guard: no module of the JAX stack or of the JAX package may
be loaded in a run of the benchmark."""

from __future__ import annotations

import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "spray_tpu"})


def offenders(modules=None):
    """Loaded modules whose top-level name (the part before the first dot)
    is banned, compared whole: `spray_tpu_torch` is not `spray_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & BANNED)


def check(when):
    """Raise SystemExit(3) naming what was found, if anything banned is
    loaded."""
    found = offenders()
    if found:
        print(f"import guard ({when}): loaded {', '.join(found)}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
