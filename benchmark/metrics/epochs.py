"""The scheduler's epochs per traced frame (EpochStats.epochs deltas)."""


def read(rec):
    d = rec.counter_delta("epochs")
    return None if d is None else d / rec.traced_steps
