"""Requests a device batch carried over the window: the difference of the
micro-batcher's ``batch_size_sum`` and ``batches`` counters."""


def read(run):
    n = run.counts["batches"]
    return run.counts["batched"] / n if n else None
