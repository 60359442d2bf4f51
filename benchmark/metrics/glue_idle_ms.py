"""Device-idle ms per traced step under the wavefront glue's spans
(`spray.glue.*`): the gaps whose innermost program span at their middle
is one of them."""

from benchmark.metrics._spans import idle_ms


def read(rec):
    return idle_ms(rec, "spray.glue.")
