"""Device-idle ms per traced step under the backward's span
(`spray.autograd.backward`): the gaps whose innermost program span at
their middle is it."""

from benchmark.metrics._spans import idle_ms


def read(rec):
    return idle_ms(rec, "spray.autograd.backward")
