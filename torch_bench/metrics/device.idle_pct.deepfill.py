"""Share of the traced window in which no operation ran on the device, in %."""


def read(run):
    if not run.trace or not run.trace.device_events:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
