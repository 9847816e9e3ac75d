"""Samples of all optimizer steps completed in the window, over the window
(host clock; the window ends with a device sync)."""


def read(run):
    return run.counts["samples"] / run.window_s
