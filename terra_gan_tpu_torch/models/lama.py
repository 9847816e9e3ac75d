"""Big-LaMa's Fourier-convolution generator (``FFCResNetGenerator``).

The published model (Suvorov et al., "Resolution-robust Large Mask
Inpainting with Fourier Convolutions", WACV 2022, arXiv:2109.07161;
github.com/advimman/lama, ``saicinpainting/training/modules/ffc.py`` and
``configs/training/big-lama.yaml``): ``ngf`` 64, three stride-2
downsamplings, 18 FFC ResNet blocks at 512 channels with
``ratio_gin = ratio_gout = 0.75`` (128 local and 384 global channels),
LFU off, reflect padding, BatchNorm, ReLU and a sigmoid output. With
this system's ends (2 channels in, 1 out) its convolutions hold 50.88 M
parameters, 50.96 M with BatchNorm's.

An FFC carries a pair (local, global) of feature maps; a branch with 0
channels is None:

  * ``y_l = conv_l2l(x_l) + conv_g2l(x_g)``,
    ``y_g = conv_l2g(x_l) + ST(x_g)``: k x k convolutions without bias,
    reflect-padded; a term whose input or output has no channels is
    absent;
  * ST (``SpectralTransform``): ``u = ReLU(BN(conv1x1_{g->g/2}(x)))``,
    then ``conv1x1_{g/2->g}(u + FU(u))``;
  * FU (``FourierUnit``): ``rfft2(u, norm="ortho")``, the real and
    imaginary parts stacked as channels interleaved per input channel
    (``[c0.re, c0.im, c1.re, ...]``), ``ReLU(BN(conv1x1_{2C->2C}))``,
    back to complex the same way, ``irfft2(s=(H, W), norm="ortho")``;
  * ``FFC_BN_ACT``: an FFC, then BatchNorm and ReLU on each branch that
    has channels; ``FFCResnetBlock``: two 3x3 of them, the input added
    back per branch.

The generator: ReflectionPad(3) and a 7x7 FFC_BN_ACT 2->ngf (local
only), three 3x3 stride-2 FFC_BN_ACTs (the last one splits its output
into local and global), the blocks, the two branches concatenated,
three ConvTranspose2d (k 3, stride 2, padding 1, output padding 1,
with bias) each with BatchNorm and ReLU, ReflectionPad(3), a 7x7 conv
ngf->1 with bias, and a sigmoid. Parameters carry LaMa's own
state-dict keys (``model.1.ffc.convl2l.weight``,
``model.5.conv1.ffc.convg2g.fu.conv_layer.weight``, ...): the layers
sit in one ``nn.Sequential`` at LaMa's indices.

The port's forward contract is PConvUNet's: ``forward(x * m, m)`` on
NHWC [B,H,W,1] with m = 1 where kept, returning the composite
``out * (1 - m) + x * m``. The network's input is ``[x * m, 1 - m]``:
LaMa's mask is 1 in the hole. H and W must divide by 2**n_downsampling.
Internally the tensors are NCHW. A block FFC's local and cross
convolutions and their sums are one call of ``ops.cuda.ffc_kernel.
ffc_local`` (a 3xTF32 tensor-core kernel on a card, the plain
``F.pad``/``F.conv2d`` version on the CPU; its parameters stay in
``convl2l``, ``convg2l`` and ``convl2g``); every other operation is
stock PyTorch (cuDNN's convolutions, cuFFT's transforms).

Under a profiler (utils/trace.py) the forward's parts are the ranges
``tg.lama_down`` (the input, the 7x7 and the downsamplings),
``tg.ffc_local`` (a block FFC's local and cross convolutions and their
sums), ``tg.ffc_spectral`` (a block FFC's ST) and ``tg.lama_up`` (the
concat, the upsampling, the 7x7 out, the sigmoid and the composite);
the blocks' BatchNorm, ReLU and residual sums lie in none of them.
``SpectralTransform.calls`` counts the STs run (2 a block a forward)
and ``SpectralTransform.elements`` the real elements they transformed
(rfft2's input).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..ops.cuda.ffc_kernel import ffc_local
from ..utils.trace import span

Pair = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]

# the published Big-LaMa generator (configs/training/big-lama.yaml)
BIG_LAMA = {"ngf": 64, "n_downsampling": 3, "n_blocks": 18, "ratio": 0.75}
# LaMa's layer indices inside ``model``: [0] ReflectionPad, [1] the 7x7 FFC_BN_ACT
FIRST_DOWN = 2


def _split(channels: int, ratio: float) -> Tuple[int, int]:
    """(local, global) channels of ``channels`` at global share ``ratio``, as LaMa rounds."""
    g = int(channels * ratio)
    return channels - g, g


def _add(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if a is None:
        return b
    return a if b is None else a + b


class FourierUnit(nn.Module):
    """1x1 conv, BatchNorm and ReLU in the frequency domain of ``rfft2``."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_layer = nn.Conv2d(2 * channels, 2 * channels, 1, bias=False)
        self.bn = nn.BatchNorm2d(2 * channels)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        b, c, h, w = u.shape
        f = torch.view_as_real(torch.fft.rfft2(u, norm="ortho"))  # [B, C, H, W/2+1, 2]
        f = f.permute(0, 1, 4, 2, 3).reshape(b, 2 * c, h, -1)  # c0.re, c0.im, c1.re, ...
        f = torch.relu(self.bn(self.conv_layer(f)))
        f = f.view(b, c, 2, h, -1).permute(0, 1, 3, 4, 2).contiguous()
        return torch.fft.irfft2(torch.view_as_complex(f), s=(h, w), norm="ortho")


class SpectralTransform(nn.Module):
    """ST: a 1x1 reduction to half the channels, the Fourier unit added
    to its input, and a 1x1 back out (stride 1, LFU off)."""

    calls = 0  # forwards run, all instances
    elements = 0  # real elements given to rfft2

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        half = out_channels // 2
        self.conv1 = nn.Sequential(nn.Conv2d(in_channels, half, 1, bias=False),
                                   nn.BatchNorm2d(half), nn.ReLU(inplace=True))
        self.fu = FourierUnit(half)
        self.conv2 = nn.Conv2d(half, out_channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("tg.ffc_spectral"):
            u = self.conv1(x)
            SpectralTransform.calls += 1
            SpectralTransform.elements += u.numel()
            return self.conv2(u + self.fu(u))


class FFC(nn.Module):
    """Fast Fourier convolution on a (local, global) pair."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 ratio_gin: float, ratio_gout: float, stride: int = 1, padding: int = 0):
        super().__init__()
        in_cl, in_cg = _split(in_channels, ratio_gin)
        out_cl, out_cg = _split(out_channels, ratio_gout)

        def conv(cin, cout):
            if not (cin and cout):
                return None
            return nn.Conv2d(cin, cout, kernel_size, stride, padding, bias=False,
                             padding_mode="reflect")

        self.convl2l = conv(in_cl, out_cl)
        self.convl2g = conv(in_cl, out_cg)
        self.convg2l = conv(in_cg, out_cl)
        if in_cg and out_cg:
            if stride != 1:
                raise ValueError("the spectral transform is built at stride 1 (LFU off)")
            self.convg2g = SpectralTransform(in_cg, out_cg)
        else:
            self.convg2g = None
        # a block's FFC: both branches in and out, 3x3 at stride 1, reflect padding 1
        self.fused = (all(c is not None for c in (self.convl2l, self.convg2l, self.convl2g,
                                                  self.convg2g))
                      and (kernel_size, stride, padding) == (3, 1, 1))

    def forward(self, x_l: Optional[torch.Tensor], x_g: Optional[torch.Tensor]) -> Pair:
        def apply(conv, x):
            return None if conv is None or x is None else conv(x)

        s = apply(self.convg2g, x_g)
        if self.fused:  # a range of its own, the local and cross convolutions in one call
            with span("tg.ffc_local"):
                return ffc_local(x_l, x_g, s, self.convl2l.weight, self.convg2l.weight,
                                 self.convl2g.weight)
        y_l = _add(apply(self.convl2l, x_l), apply(self.convg2l, x_g))
        y_g = _add(apply(self.convl2g, x_l), s)
        return y_l, y_g


class FFC_BN_ACT(nn.Module):  # noqa: N801 - LaMa's name, and its state-dict keys
    """An FFC, then BatchNorm and ReLU on each branch that has channels."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 ratio_gin: float, ratio_gout: float, stride: int = 1, padding: int = 0):
        super().__init__()
        self.ffc = FFC(in_channels, out_channels, kernel_size, ratio_gin, ratio_gout, stride,
                       padding)
        out_cl, out_cg = _split(out_channels, ratio_gout)
        self.bn_l = nn.BatchNorm2d(out_cl) if out_cl else None
        self.bn_g = nn.BatchNorm2d(out_cg) if out_cg else None

    def forward(self, x_l: Optional[torch.Tensor], x_g: Optional[torch.Tensor] = None) -> Pair:
        y_l, y_g = self.ffc(x_l, x_g)
        if y_l is not None:
            y_l = torch.relu(self.bn_l(y_l))
        if y_g is not None:
            y_g = torch.relu(self.bn_g(y_g))
        return y_l, y_g


class FFCResnetBlock(nn.Module):
    """Two 3x3 FFC_BN_ACTs, the input added back to each branch."""

    def __init__(self, dim: int, ratio: float):
        super().__init__()
        self.conv1 = FFC_BN_ACT(dim, dim, 3, ratio, ratio, padding=1)
        self.conv2 = FFC_BN_ACT(dim, dim, 3, ratio, ratio, padding=1)

    def forward(self, x_l: torch.Tensor, x_g: torch.Tensor) -> Pair:
        y_l, y_g = self.conv2(*self.conv1(x_l, x_g))
        return x_l + y_l, x_g + y_g


class ConcatTupleLayer(nn.Module):
    """The (local, global) pair as one map, channels concatenated."""

    def forward(self, x_l: torch.Tensor, x_g: Optional[torch.Tensor]) -> torch.Tensor:
        return x_l if x_g is None else torch.cat([x_l, x_g], 1)


class FFCResNetGenerator(nn.Module):
    """Big-LaMa's generator at this system's ends: 2 channels in
    (``[x * m, 1 - m]``), 1 out. The defaults are the published sizes
    (``BIG_LAMA``)."""

    def __init__(self, ngf: int = 64, n_downsampling: int = 3, n_blocks: int = 18,
                 ratio: float = 0.75):
        super().__init__()
        self.sizes = {"ngf": ngf, "n_downsampling": n_downsampling, "n_blocks": n_blocks,
                      "ratio": ratio}
        # LaMa caps widths at max_features (1024), which the published sizes never reach
        width = [ngf * 2**i for i in range(n_downsampling + 1)]
        layers = [nn.ReflectionPad2d(3), FFC_BN_ACT(2, ngf, 7, 0.0, 0.0)]
        for i in range(n_downsampling):
            last = i == n_downsampling - 1
            layers.append(FFC_BN_ACT(width[i], width[i + 1], 3, 0.0, ratio if last else 0.0,
                                     stride=2, padding=1))
        layers += [FFCResnetBlock(width[-1], ratio) for _ in range(n_blocks)]
        layers.append(ConcatTupleLayer())
        for i in range(n_downsampling, 0, -1):
            layers += [nn.ConvTranspose2d(width[i], width[i - 1], 3, 2, 1, output_padding=1),
                       nn.BatchNorm2d(width[i - 1]), nn.ReLU(inplace=True)]
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, 1, 7), nn.Sigmoid()]
        self.model = nn.Sequential(*layers)
        self._blocks = FIRST_DOWN + n_downsampling  # the first block's index

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B,H,W,1] in [0,1], already multiplied by the mask; mask
        [B,H,W,1], 1 = preserved. Returns the composite, same shape."""
        step = 2 ** self.sizes["n_downsampling"]
        if x.shape[1] % step or x.shape[2] % step:
            raise ValueError(f"FFCResNetGenerator takes sides that divide by {step}, "
                             f"got {tuple(x.shape[1:3])}")
        first, concat = self._blocks, self._blocks + self.sizes["n_blocks"]
        with span("tg.lama_down"):
            m = mask.permute(0, 3, 1, 2)
            # NHWC [B,H,W,1] permuted reads as channels-last: the network runs NCHW
            h = torch.cat([x.permute(0, 3, 1, 2), 1.0 - m], 1).contiguous()
            pair: Pair = (self.model[0](h), None)
            for layer in self.model[1:first]:
                pair = layer(*pair)
        for block in self.model[first:concat]:
            pair = block(*pair)
        with span("tg.lama_up"):
            h = self.model[concat](*pair)
            out = self.model[concat + 1 :](h).permute(0, 2, 3, 1)
            return out * (1.0 - mask) + x * mask


def is_lama_state(state: Mapping[str, torch.Tensor]) -> bool:
    """Whether a state dict is an FFCResNetGenerator's (by LaMa's keys)."""
    return "model.1.ffc.convl2l.weight" in state


def sizes_from_state(state: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """The constructor's sizes that a generator's state dict was built with."""
    idx = {int(k.split(".")[1]) for k in state if k.startswith("model.")}
    down = sum(f"model.{i}.ffc.convl2l.weight" in state for i in idx if i >= FIRST_DOWN)
    blocks = sorted(i for i in idx if f"model.{i}.conv1.bn_l.weight" in state)
    ngf = int(state["model.1.ffc.convl2l.weight"].shape[0])
    local = int(state[f"model.{blocks[0]}.conv1.bn_l.weight"].shape[0])
    glob = int(state[f"model.{blocks[0]}.conv1.bn_g.weight"].shape[0])
    return {"ngf": ngf, "n_downsampling": down, "n_blocks": len(blocks),
            "ratio": glob / (local + glob)}
