"""torch.cuda.max_memory_allocated() over the traced window, after
reset_peak_memory_stats() at its start, in GiB."""


def read(rec):
    return None if rec.window_peak_bytes is None else rec.window_peak_bytes / 2**30
