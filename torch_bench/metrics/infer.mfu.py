"""The forward's convolution operations over the window, as a share of the
chip's fp32-accurate peak (torch_bench/work.py)."""

from torch_bench import work


def read(run):
    cfg = run.config
    flops = run.counts["tiles"] * work.generator_forward_flops(cfg["base_width"], cfg["image_size"])
    return 100.0 * flops / run.window_s / work.FP32_ACCURATE_FLOPS
