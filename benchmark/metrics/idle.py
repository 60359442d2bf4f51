"""1 - device busy / wall over the traced window; busy is the union of the
device's event intervals."""

from benchmark.profile import busy_us


def read(rec):
    if rec.trace is None or not rec.trace.device:
        return None
    busy_s = busy_us((iv.start_us, iv.end_us) for iv in rec.trace.device) / 1e6
    return 1.0 - busy_s / rec.traced_wall_s
