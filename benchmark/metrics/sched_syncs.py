"""Host reads of device values per traced step in the scheduler's loop:
the program's `spray.sync.*` spans inside a `spray.sched.*` span (queue
counts, the epoch loop's flags, the traced and speculative counts)."""

from benchmark.metrics._spans import syncs_per_step


def read(rec):
    return syncs_per_step(rec, in_sched=True)
