"""Speculation efficiency over the traced window: committed hits over the
ray-domain trace activations (EpochStats deltas)."""


def read(rec):
    traced = rec.counter_delta("rays_traced")
    committed = rec.counter_delta("committed")
    if not traced or committed is None:
        return None
    return committed / traced
