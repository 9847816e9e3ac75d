"""The allocator's peak over the window (``max_memory_allocated``), GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
