"""The GAN step's convolution and attention operations over the window with
DeepFill v2 as G (counted from the shapes, work_deepfill.train_step_flops),
as a share of the chip's fp32-accurate peak, in %."""

from torch_bench import work, work_deepfill


def read(run):
    cfg = run.config
    per_sample = work_deepfill.train_step_flops(cfg["image_size"], cfg["discriminator_width"],
                                                cfg["cnum"])
    return 100.0 * run.counts["samples"] * per_sample / run.window_s / work.FP32_ACCURATE_FLOPS
