"""Operations and parameters of Big-LaMa's generator from its shapes.

The yardstick of ``lama.mfu``, counted as ``work.py`` counts the PConv
U-Net's: one multiply-add of a convolution is 2 operations, a
transposed convolution's as the convolution it is the adjoint of
(2 x input pixels x c_in x c_out x k^2). The FFTs and the
element-wise work (BatchNorm, ReLU, sums) are not counted. The Fourier
unit's 1x1 conv runs over H x (W/2 + 1) frequencies.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import work

# (part, c_in, c_out, k, output pixels or, for a transposed conv, input pixels, bias)
Conv = Tuple[str, int, int, int, int, bool]


def generator_convs(side: int, ngf: int = 64, n_downsampling: int = 3, n_blocks: int = 18,
                    ratio: float = 0.75) -> List[Conv]:
    """Every convolution of one tile's forward, in order, by part: "ends"
    (the 7x7 in and out), "down", "blocks" and "up"."""
    width = [ngf * 2**i for i in range(n_downsampling + 1)]
    rows: List[Conv] = [("ends", 2, ngf, 7, side * side, False)]
    for i in range(n_downsampling):
        s = side >> (i + 1)
        g = int(width[i + 1] * ratio) if i == n_downsampling - 1 else 0
        rows += [("down", width[i], c, 3, s * s, False) for c in (width[i + 1] - g, g) if c]
    s = side >> n_downsampling
    dim = width[-1]
    g = int(dim * ratio)
    local, half = dim - g, g // 2
    ffc = [(local, local, 3, s * s), (local, g, 3, s * s), (g, local, 3, s * s),  # l2l, l2g, g2l
           (g, half, 1, s * s), (2 * half, 2 * half, 1, s * (s // 2 + 1)),  # ST's conv1, FU
           (half, g, 1, s * s)]  # ST's conv2
    rows += [("blocks", ci, co, k, n, False) for _ in range(2 * n_blocks) for ci, co, k, n in ffc]
    for i in range(n_downsampling, 0, -1):
        s = side >> i
        rows.append(("up", width[i], width[i - 1], 3, s * s, True))
    return rows + [("ends", ngf, 1, 7, side * side, True)]


def conv_flops(row: Conv) -> float:
    _, ci, co, k, pixels, _ = row
    return 2.0 * pixels * ci * co * k * k


def forward_flops(side: int, **sizes) -> float:
    """Convolution operations of one tile's forward."""
    return sum(conv_flops(r) for r in generator_convs(side, **sizes))


def forward_flops_by_part(side: int, **sizes) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in generator_convs(side, **sizes):
        out[r[0]] = out.get(r[0], 0.0) + conv_flops(r)
    return out


def parameters(**sizes) -> int:
    """The convolutions' weights and biases (BatchNorm's not counted)."""
    return sum(ci * co * k * k + (co if bias else 0)
               for _, ci, co, k, _, bias in generator_convs(8, **sizes))


def train_step_flops(side: int, discriminator_width: int = 64, **sizes) -> float:
    """Convolution operations of one sample's GAN step, as
    ``work.train_step_flops`` counts them: G's forward, weight gradients
    everywhere and input gradients but the first conv's; VGG's two
    forwards and the prediction's input gradients; D's three forwards
    with their gradients."""
    g = generator_convs(side, **sizes)
    total = 3 * sum(conv_flops(r) for r in g) - conv_flops(g[0])
    total += 3 * sum(work.vgg_flops(side))
    d = work.discriminator_flops(discriminator_width, side)
    return total + 3 * sum(d) + 3 * sum(d) + (sum(d) + 2 * (sum(d) - d[0]))


def summary(side: int = 512) -> Dict[str, float]:
    return {"forward_gflop_per_tile": forward_flops(side) / 1e9,
            **{f"{k}_gflop": v / 1e9 for k, v in forward_flops_by_part(side).items()},
            "gan_step_gflop_per_sample": train_step_flops(side) / 1e9,
            "parameters_m": parameters() / 1e6}
