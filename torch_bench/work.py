"""Operations and bytes from the model's shapes, and the chip's peaks.

The yardstick of every share in the benchmark: a share is the least time
the work could take at the peaks below over the time it took. Peaks are
NVIDIA's data sheet for one H100 SXM at its 700 W limit: 495 TFLOP/s of
dense TF32, of which fp32-accurate products (3xTF32: three TF32 products
each) come at a third, 165 TFLOP/s; 67 TFLOP/s of fp32 outside the
tensor cores; 3.35 TB/s of HBM. The count is of what the algorithm
needs, whatever the implementation: one multiply-add of a convolution
is 2 operations, and each byte of a kernel's inputs is read once and
each byte of its outputs written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .reference.models import VGG_CONVS, discriminator_convs, generator_stages

FP32_ACCURATE_FLOPS = 165e12
FP32_SIMT_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def generator_convs(w: int, side: int) -> List[Tuple[str, int, int, int, int, int]]:
    """(name, c_in, c_out, k, out side, in side) of every conv of the U-Net."""
    sides = [side >> i for i in range(8)]  # sides[i]: enc_i's output, sides[0] the input
    rows = []
    for name, ci, co, k, stride in generator_stages(w):
        i = int(name[3:])
        if name.startswith("enc"):
            rows.append((name, ci, co, k, sides[i], sides[i - 1]))
        else:
            rows.append((name, ci, co, k, sides[i - 1], sides[i - 1]))
    rows.append(("final", w, 1, 3, side, side))
    return rows


def conv_flops(ci: int, co: int, k: int, out_side: int) -> float:
    return 2.0 * out_side * out_side * co * ci * k * k


def generator_forward_flops(w: int, side: int) -> float:
    """Convolution operations of one tile's forward."""
    return sum(conv_flops(ci, co, k, s) for _, ci, co, k, s, _ in generator_convs(w, side))


def discriminator_flops(w: int, side: int) -> List[float]:
    """Per conv of PatchGAN, in order."""
    out, s = [], side
    for _, ci, co, stride, pad, _ in discriminator_convs(w):
        s = (s + 2 * pad - 4) // stride + 1
        out.append(conv_flops(ci, co, 4, s))
    return out


def vgg_flops(side: int) -> List[float]:
    out, s = [], side
    for key, ci, co in VGG_CONVS:
        out.append(conv_flops(ci, co, 3, s))
        if key in ("features.2", "features.7"):
            s //= 2
    return out


def train_step_flops(mode: str, w: int, side: int) -> float:
    """Convolution operations of one sample's train step.

    A conv's forward is F, the gradient of its weights F, of its input F.
    G: forward, weight gradients everywhere, input gradients but enc1's
    (the input needs none). VGG (frozen): the forwards of the prediction
    and the target, and input gradients along the prediction's path.
    "gan" adds D: D(gen) in the G step (weight and input gradients, since
    D's parameters require them), D(real) and D(gen.detach()) in the D
    step (weight gradients, input gradients but the first conv's).
    """
    g = generator_convs(w, side)
    total = sum(3 * conv_flops(ci, co, k, s) for _, ci, co, k, s, _ in g)
    total -= conv_flops(*g[0][1:5])  # enc1's input gradient
    v = vgg_flops(side)
    total += 3 * sum(v)
    if mode == "gan":
        d = discriminator_flops(w, side)
        total += 3 * sum(d) + 3 * sum(d) + (sum(d) + 2 * (sum(d) - d[0]))
    return total


def k2_stage_bound(ci: int, co: int, k: int, out_side: int, in_side: int, batch: int) -> float:
    """Seconds: a partial-conv stage (conv, renormalisation, folded
    BatchNorm, ReLU) at the fp32-accurate rate or the bytes, which bounds."""
    flops = batch * conv_flops(ci, co, k, out_side)
    moved = F32 * (batch * in_side * in_side * (ci + 1)          # features, mask
                   + co * ci * k * k + 3 * co                     # weight, bias, BatchNorm
                   + batch * out_side * out_side * (co + 1))      # features, new mask
    return max(flops / FP32_ACCURATE_FLOPS, moved / HBM_BYTES_PER_S)


def k2_forward_bound(w: int, side: int, batch: int) -> float:
    """Seconds of K2 in one eval forward: its 13 stages (dec1 is K3's)
    and the pack of the 14 stages' weights (read 4 bytes, write 8)."""
    stages = [r for r in generator_convs(w, side) if r[0] not in ("dec1", "final")]
    t = sum(k2_stage_bound(ci, co, k, s, s_in, batch) for _, ci, co, k, s, s_in in stages)
    weights = sum(co * ci * k * k for _, ci, co, k, _, _ in generator_convs(w, side)[:-1])
    return t + 12 * weights / HBM_BYTES_PER_S


def k3_forward_bound(w: int, side: int, batch: int) -> float:
    """Seconds of K3 in one eval forward: from dec2's features and mask,
    the 2x upsample, dec1 at the fp32-accurate rate, the final 64->1 conv
    in fp32, the sigmoid and the composite."""
    flops_dec1 = batch * conv_flops(w, w, 3, side)
    flops_final = batch * conv_flops(w, 1, 3, side)
    half = side // 2
    moved = F32 * (batch * half * half * (w + 1) + w * w * 9 + 3 * w + w * 9 + 1
                   + batch * side * side * 3)  # x, mask in; the composite out
    return max(flops_dec1 / FP32_ACCURATE_FLOPS + flops_final / FP32_SIMT_FLOPS,
               moved / HBM_BYTES_PER_S)


def summary(w: int = 64, side: int = 512) -> Dict[str, float]:
    return {"forward_gflop_per_tile": generator_forward_flops(w, side) / 1e9,
            "gan_step_gflop_per_sample": train_step_flops("gan", w, side) / 1e9,
            "hg_step_gflop_per_sample": train_step_flops("hg", w, side) / 1e9,
            "k2_bound_ms_batch8": k2_forward_bound(w, side, 8) * 1e3,
            "k3_bound_ms_batch8": k3_forward_bound(w, side, 8) * 1e3}
