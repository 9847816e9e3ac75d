"""Partial convolution in plain PyTorch, NHWC in and out.

The counterpart of terra_gan_tpu/ops/pconv.py, with the reference
layer's numerics (mvp_gan/src/models/pconv.py:25-50): the bias sits
inside the renormalisation,

    out      = (conv(x * m) + b) * ratio
    ratio    = K / (sum_win(m) + 1e-8) * (sum_win(m) > 0)
    new_mask = (sum_win(m) > 0)

with K = kh * kw and sum_win the frozen all-ones mask conv. Tensors are
NHWC ([B, H, W, C], masks [B, H, W, 1]) and kernels HWIO
([kh, kw, C, O]), as in the JAX package, so both take the same arrays.
fp32 and f64 keep their dtype. On a card, turn TF32 off
(``torch.backends.cudnn.allow_tf32 = False``) for fp32 parity: it is the
counterpart of the JAX package's ``precision="highest"``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def mask_window_sum(
    mask: torch.Tensor, kh: int, kw: int, stride: int, padding: int
) -> torch.Tensor:
    """Box-sum of the mask over the conv window: [B,H,W,1] -> [B,H',W',1].

    Zero padding at the edges, as the ones-conv pads. Counts of a 0/1
    mask are integers, exact in every float dtype.
    """
    s = F.avg_pool2d(
        _nchw(mask), (kh, kw), stride, padding,
        count_include_pad=True, divisor_override=1,
    )
    return _nhwc(s)


def renorm_ratio(
    mask: torch.Tensor, kh: int, kw: int, stride: int, padding: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ratio, sum_win(m) > 0), both [B,H',W',1]. The ratio is data only:
    no gradient flows through it (stop_gradient in the JAX package)."""
    msum = mask_window_sum(mask, kh, kw, stride, padding).detach()
    valid = msum > 0
    return torch.where(valid, (kh * kw) / (msum + 1e-8), torch.zeros_like(msum)), valid


def _renorm(out, mask, kh, kw, stride, padding, bias):
    ratio, valid = renorm_ratio(mask, kh, kw, stride, padding)
    return (out + bias) * ratio, valid.to(mask.dtype)


def partial_conv2d(
    x: torch.Tensor,
    mask: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    stride: int,
    padding: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial convolution forward: (out [B,H',W',O], new_mask [B,H',W',1])."""
    return partial_conv2d_split((x,), mask, kernel, bias, stride, padding)


def partial_conv2d_split(
    parts: Sequence[torch.Tensor],
    mask: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    stride: int,
    padding: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial conv over the implicit channel concat of ``parts``.

    conv(concat(a, b) * m, W) == conv(a*m, W[:, :, :ca]) + conv(b*m, W[:, :, ca:]),
    so the concatenated tensor is never built.
    """
    kh, kw = kernel.shape[0], kernel.shape[1]
    m = _nchw(mask)
    out = None
    offset = 0
    for part in parts:
        ch = part.shape[-1]
        w = kernel[:, :, offset : offset + ch, :].permute(3, 2, 0, 1)
        offset += ch
        y = F.conv2d(_nchw(part) * m, w, stride=stride, padding=padding)
        out = y if out is None else out + y
    if offset != kernel.shape[2]:
        raise ValueError(
            f"parts cover {offset} channels, the kernel has {kernel.shape[2]}"
        )
    return _renorm(_nhwc(out), mask, kh, kw, stride, padding, bias)
