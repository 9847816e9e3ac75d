"""Device ms a step launched inside the program's ``tg.ffc_spectral``
ranges (the blocks' spectral transforms, forward), over the profiled
steps that follow the window in a traced run (drivers/lama_train.py);
None where the program has no such range or the run had no card."""


def read(run):
    return run.counts.get("spectral_device_ms") or None
