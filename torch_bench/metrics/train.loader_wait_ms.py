"""Host time a step waited on ``next()`` of the loader, mean per step, in ms."""


def read(run):
    n = run.span_n.get("loader", 0)
    return 1e3 * run.span_s["loader"] / n if n else None
