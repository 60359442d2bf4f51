"""Seconds the entry took to build its intersector (host page build and
upload), fenced: the harness's clock around the program's constructor."""


def read(rec):
    return rec.build_s
