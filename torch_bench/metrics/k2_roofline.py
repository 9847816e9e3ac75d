"""K2's least time (its 13 stages and the weight pack, work.k2_forward_bound)
over the device time of its kernels in the trace, in %."""

from torch_bench import work

KERNELS = ("pconv_", "pack_tf32")


def read(run):
    t = run.trace.kernel_seconds(*KERNELS) if run.trace else 0.0
    if t <= 0:
        return None
    cfg = run.config
    bound = sum(work.k2_forward_bound(cfg["base_width"], cfg["image_size"], b)
                for b in run.counts["forward_batches"])
    return 100.0 * bound / t
