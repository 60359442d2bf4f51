"""Device-idle ms per traced frame under the collective epochs' spans
(`spray.dist.*`: the router, the exchanges, the owner's local trace, the
home-side commit, the liveness reduce and the frame's gather): the gaps
whose innermost program span at their middle is one of them.  None where
the program opens no such span."""

from benchmark.metrics._spans import idle_ms, program_spans

PREFIX = "spray.dist."


def read(rec):
    if rec.trace is None or not any(iv.name.startswith(PREFIX)
                                    for iv in program_spans(rec.trace)):
        return None
    return idle_ms(rec, PREFIX)
