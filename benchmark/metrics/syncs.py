"""Host reads of device values per traced step outside the scheduler: the
program's `spray.sync.*` spans that lie in no `spray.sched.*` span (those
are `sched_syncs`)."""

from benchmark.metrics._spans import syncs_per_step


def read(rec):
    return syncs_per_step(rec, in_sched=False)
