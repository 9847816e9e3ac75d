"""Tiles returned to the host as uint8 over the window (host clock)."""


def read(run):
    return run.counts["tiles"] / run.window_s
