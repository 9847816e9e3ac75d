"""Operations, bytes and parameters of DeepFill v2's generator from its shapes.

The yardstick of ``deepfill.mfu`` and ``deepfill.ctx_attn_roofline``,
counted as ``work.py`` counts the PConv U-Net's: one multiply-add is 2
operations, a convolution's at its output pixels (a gen_deconv's conv
at the upsampled side). The contextual attention's two products are
counted per image at L = (side / 8)^2 queries and keys: the scores,
2 L^2 (9 C), and the paste, 2 L^2 (16 C), C = 4 cnum / 2 channels.
The element-wise work (gates, the fuse, the softmax, the patch copies)
is not counted.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import work
from .reference import deepfill as reference

# (part, c_in, c_out, k, output pixels) of a convolution
Conv = Tuple[str, int, int, int, int]


def generator_convs(side: int, cnum: int = 48) -> List[Conv]:
    """Every convolution of one tile's forward, in order, by part:
    "coarse" (stage 1, ``conv*``) and "refine" (stage 2)."""
    return [("coarse" if name.startswith("conv") else "refine", ci, co, k, (side // div) ** 2)
            for name, ci, co, k, div in reference.layers(cnum)]


def conv_flops(row: Conv) -> float:
    _, ci, co, k, pixels = row
    return 2.0 * pixels * ci * co * k * k


def ctx_attn_flops(side: int, cnum: int = 48) -> float:
    """The attention's two products, one tile's forward."""
    length = (side // 8) ** 2
    c = 2 * cnum
    return 2.0 * length * length * (9 * c + 16 * c)


def forward_flops(side: int, cnum: int = 48) -> float:
    """Convolution and attention operations of one tile's forward."""
    return sum(conv_flops(r) for r in generator_convs(side, cnum)) + ctx_attn_flops(side, cnum)


def forward_flops_by_part(side: int, cnum: int = 48) -> Dict[str, float]:
    out: Dict[str, float] = {"ctx_attn": ctx_attn_flops(side, cnum)}
    for r in generator_convs(side, cnum):
        out[r[0]] = out.get(r[0], 0.0) + conv_flops(r)
    return out


def parameters(cnum: int = 48) -> int:
    """The convolutions' weights and biases."""
    return sum(ci * co * k * k + co for _, ci, co, k, _ in generator_convs(8, cnum))


def train_step_flops(side: int, discriminator_width: int = 64, cnum: int = 48) -> float:
    """Operations of one sample's GAN step, as ``work_lama.train_step_flops``
    counts them: G's forward, weight gradients everywhere and input
    gradients but the first conv's (the attention's products: both
    operands' gradients); VGG's two forwards and the prediction's input
    gradients; D's three forwards with their gradients."""
    g = generator_convs(side, cnum)
    total = 3 * forward_flops(side, cnum) - conv_flops(g[0])
    total += 3 * sum(work.vgg_flops(side))
    d = work.discriminator_flops(discriminator_width, side)
    return total + 3 * sum(d) + 3 * sum(d) + (sum(d) + 2 * (sum(d) - d[0]))


def ctx_attn_forward_bound(batch: float, side: int = 512, cnum: int = 48) -> float:
    """Seconds of the attention in one forward: its products at the
    fp32-accurate rate, or its least bytes (the features read once, the
    hole mask at their side, the output written), whichever bounds."""
    flops = batch * ctx_attn_flops(side, cnum)
    pixels = (side // 4) ** 2
    moved = work.F32 * batch * pixels * (2 * (2 * cnum) + 1)
    return max(flops / work.FP32_ACCURATE_FLOPS, moved / work.HBM_BYTES_PER_S)


def summary(side: int = 512) -> Dict[str, float]:
    return {"forward_gflop_per_tile": forward_flops(side) / 1e9,
            **{f"{k}_gflop": v / 1e9 for k, v in forward_flops_by_part(side).items()},
            "gan_step_gflop_per_sample": train_step_flops(side) / 1e9,
            "ctx_attn_bound_ms_batch16": 1e3 * ctx_attn_forward_bound(16, side),
            "parameters_m": parameters() / 1e6}
