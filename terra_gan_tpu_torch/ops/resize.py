"""Fixed-factor spatial resampling, NHWC, with the reference's semantics.

The counterpart of terra_gan_tpu/ops/resize.py. The reference decoder
upsamples features with ``F.interpolate(scale_factor=2, mode="bilinear",
align_corners=False)`` and masks with ``mode="nearest"``, then pads (or
crops) to the skip's size (mvp_gan/src/models/generator.py:50-51,
66-67, 78-84).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda.upsample_kernel import Upsample2x

# The JAX package's name for the NHWC 2x bilinear upsample, with its
# gradient: K1 forward and backward on a card, F.interpolate and its
# autograd backward on the CPU.
upsample2x_bilinear = Upsample2x.apply


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x nearest upsample: out[2i] = out[2i+1] = in[i]."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def pad_to_match(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Zero-pad, or crop, an NHWC tensor spatially to (target_h, target_w).

    Top/left gets diff // 2 and bottom/right the rest, as the reference's
    ``_pad_to_match``; a negative diff crops, as torch's F.pad does with
    negative entries (the JAX package reproduces the same split).
    """
    dh = target_h - x.shape[1]
    dw = target_w - x.shape[2]
    if dh == 0 and dw == 0:
        return x
    return F.pad(x, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
