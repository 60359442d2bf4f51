"""Device milliseconds per traced frame in NCCL's kernels (the all-to-all
exchanges, the all-reduces and the all-gather), from the profiler's device
events, overlaps counted once.  A collective kernel runs from the moment
this rank's card starts it until every peer has joined and the data have
moved: this counts both the wire and the rank's wait on its slowest peer.
None where the run launched no NCCL kernel."""

import re

from benchmark.profile import busy_us

KERNELS = re.compile(r"^nccl", re.IGNORECASE)


def read(rec):
    if rec.trace is None:
        return None
    us = busy_us((iv.start_us, iv.end_us) for iv in rec.trace.device
                 if KERNELS.search(iv.name))
    return us / 1e3 / rec.traced_steps if us > 0 else None
