"""Domain uploads per traced frame (EpochStats.domain_loads deltas)."""


def read(rec):
    d = rec.counter_delta("domain_loads")
    return None if d is None else d / rec.traced_steps
