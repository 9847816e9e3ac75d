"""The train step's convolution operations over the window (counted from
the shapes, work.train_step_flops), as a share of the chip's
fp32-accurate peak, in %."""

from torch_bench import work


def read(run):
    cfg = run.config
    per_sample = work.train_step_flops(run.traffic["step"], cfg["base_width"], cfg["image_size"])
    return 100.0 * run.counts["samples"] * per_sample / run.window_s / work.FP32_ACCURATE_FLOPS
