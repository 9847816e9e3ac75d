"""The contextual attention's forward bound (work_deepfill.ctx_attn_forward_bound:
its two products at the fp32-accurate peak, or its least bytes) over the
device time launched inside ``tg.ctx_attn`` a step, in %; None where that
time was not read."""

from torch_bench import work_deepfill


def read(run):
    ms = run.counts.get("ctx_attn_device_ms")
    if not ms:
        return None
    bound = work_deepfill.ctx_attn_forward_bound(run.counts["ctx_attn_batch"],
                                                 run.config["image_size"], run.config["cnum"])
    return 100.0 * 1e3 * bound / ms
