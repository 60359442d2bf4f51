"""Device kernels, copies and sets per traced step, counted from the
profiler's device events."""


def read(rec):
    if rec.trace is None or not rec.trace.device:
        return None
    return len(rec.trace.device) / rec.traced_steps
