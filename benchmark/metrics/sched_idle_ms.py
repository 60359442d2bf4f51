"""Device-idle ms per traced frame under the scheduler's spans
(`spray.sched.*`): the gaps whose innermost program span at their middle
is one of them."""

from benchmark.metrics._spans import idle_ms


def read(rec):
    return idle_ms(rec, "spray.sched.")
