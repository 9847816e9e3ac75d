"""The GAN step's convolution operations over the window with Big-LaMa as
G (counted from the shapes, work_lama.train_step_flops), as a share of
the chip's fp32-accurate peak, in %."""

from torch_bench import work, work_lama


def read(run):
    cfg = run.config
    per_sample = work_lama.train_step_flops(
        cfg["image_size"], cfg["discriminator_width"], ngf=cfg["ngf"],
        n_downsampling=cfg["n_downsampling"], n_blocks=cfg["n_blocks"], ratio=cfg["ratio_gin"])
    return 100.0 * run.counts["samples"] * per_sample / run.window_s / work.FP32_ACCURATE_FLOPS
