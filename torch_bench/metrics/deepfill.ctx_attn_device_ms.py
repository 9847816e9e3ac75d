"""Device ms a step launched inside the program's ``tg.ctx_attn`` range (the
contextual attention's forward), over the profiled steps that follow the
window in a traced run (drivers/deepfill_train.py); None where the
program has no such range or the run had no card."""


def read(run):
    return run.counts.get("ctx_attn_device_ms") or None
