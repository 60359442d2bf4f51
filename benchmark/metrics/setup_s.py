"""Seconds from the start of the process to the first timed step: the
scene made, the pages built, the kernels loaded, one warm-up step."""


def read(rec):
    return rec.setup_s
