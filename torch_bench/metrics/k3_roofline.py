"""K3's least time (dec1, the final conv and the composite,
work.k3_forward_bound) over the device time of its kernel, in %."""

from torch_bench import work

KERNELS = ("decoder_tail",)


def read(run):
    t = run.trace.kernel_seconds(*KERNELS) if run.trace else 0.0
    if t <= 0:
        return None
    cfg = run.config
    bound = sum(work.k3_forward_bound(cfg["base_width"], cfg["image_size"], b)
                for b in run.counts["forward_batches"])
    return 100.0 * bound / t
