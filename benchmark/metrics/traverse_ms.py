"""Device milliseconds per traced step of the traversal kernels of
`csrc/traverse.cu`, from the profiler's device events."""

import re

KERNELS = re.compile(
    r"(?<![A-Za-z0-9_])(nearest_kernel|anyhit_kernel|nearest_slot_kernel)"
    r"(?![A-Za-z0-9_])")


def read(rec):
    if rec.trace is None:
        return None
    us = sum(iv.end_us - iv.start_us for iv in rec.trace.device
             if KERNELS.search(iv.name))
    return us / 1e3 / rec.traced_steps if us > 0 else None
