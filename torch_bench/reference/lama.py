"""Plain-PyTorch reference of Big-LaMa's FFC ResNet generator, NCHW, float32.

Written from the published equations (Suvorov et al., WACV 2022,
arXiv:2109.07161; github.com/advimman/lama,
saicinpainting/training/modules/ffc.py and configs/training/big-lama.yaml),
not from the program under test, which it does not import. Functions
take a flat parameter dict under LaMa's state-dict keys
(``model.1.ffc.convl2l.weight``, ...); the layout (downsamplings,
blocks, branch widths) is read from the keys present.

  FFC:  y_l = conv_l2l(x_l) + conv_g2l(x_g);  y_g = conv_l2g(x_l) + ST(x_g)
        k x k, no bias, reflect padding; a term whose weight is absent
        (0 channels in or out) is left out
  ST:   u = ReLU(BN(conv1x1(x)));  conv1x1(u + FU(u))
  FU:   F = rfft2(u, ortho); [re, im] stacked per channel (c0.re, c0.im,
        c1.re, ...); ReLU(BN(conv1x1)); back to complex; irfft2(s=(H, W), ortho)
  generator: reflect pad 3, 7x7 FFC+BN+ReLU on [x * m, 1 - m]; stride-2
        3x3 FFCs; FFC ResNet blocks (two 3x3 FFC+BN+ReLU, the input added
        back per branch); [l, g] concatenated; ConvTranspose2d (3, 2, 1,
        output padding 1) + BN + ReLU; reflect pad 3, 7x7 conv, sigmoid;
        the composite out * (1 - m) + x * m.

Departures from the published model, shared with the program's
contract: 2 input channels (the masked DSM and the hole mask) where
Big-LaMa has 4, one output channel where it has 3. The GAN step is this
system's objective (``reference.steps.TrainReference``'s), not LaMa's.

Every convolution goes through ``models.conv2d`` and
``conv_transpose2d``, so that ``precision`` sets the arithmetic of all
of them: on the CPU its "tf32" rounds their operands to TF32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from . import models, steps
from .models import Params
from .steps import TrainReference, nchw

conv_transpose2d = F.conv_transpose2d
_CONV_T = F.conv_transpose2d


def _tf32_conv_transpose2d(x, w, b=None, *args, **kw):
    return _CONV_T(steps.tf32_round(x), steps.tf32_round(w), b, *args, **kw)


@contextlib.contextmanager
def precision(name: str, device: torch.device):
    """``steps.precision`` for this reference: on the CPU its "tf32" also
    rounds the transposed convolutions' operands."""
    global conv_transpose2d
    with steps.precision(name, device):
        emulate = name == "tf32" and device.type != "cuda"
        if emulate:
            conv_transpose2d = _tf32_conv_transpose2d
        try:
            yield
        finally:
            conv_transpose2d = _CONV_T


# -- parameter spec: (key, shape, init rule) as torch_bench/weights.py draws --

def _split(c: int, ratio: float):
    g = int(c * ratio)
    return c - g, g


def _conv(key: str, cin: int, cout: int, k: int, bias: bool = False):
    out = [(f"{key}.weight", (cout, cin, k, k), ("he", cin * k * k))]
    if bias:
        out.append((f"{key}.bias", (cout,), ("uniform", (cin * k * k) ** -0.5)))
    return out


def _ffc_bn_act(key: str, cin: int, cout: int, k: int, rin: float, rout: float):
    (il, ig), (ol, og) = _split(cin, rin), _split(cout, rout)
    spec = []
    for name, a, b in (("convl2l", il, ol), ("convl2g", il, og), ("convg2l", ig, ol)):
        if a and b:
            spec += _conv(f"{key}.ffc.{name}", a, b, k)
    if ig and og:
        st, half = f"{key}.ffc.convg2g", og // 2
        spec += _conv(f"{st}.conv1.0", ig, half, 1) + models._bn_spec(f"{st}.conv1.1", half)
        spec += _conv(f"{st}.fu.conv_layer", 2 * half, 2 * half, 1)
        spec += models._bn_spec(f"{st}.fu.bn", 2 * half) + _conv(f"{st}.conv2", half, og, 1)
    if ol:
        spec += models._bn_spec(f"{key}.bn_l", ol)
    if og:
        spec += models._bn_spec(f"{key}.bn_g", og)
    return spec


def generator_spec(ngf: int = 64, n_downsampling: int = 3, n_blocks: int = 18,
                   ratio: float = 0.75):
    """Every tensor of the generator's state dict, in LaMa's order."""
    width = [ngf * 2**i for i in range(n_downsampling + 1)]
    spec = _ffc_bn_act("model.1", 2, ngf, 7, 0.0, 0.0)
    for i in range(n_downsampling):
        rout = ratio if i == n_downsampling - 1 else 0.0
        spec += _ffc_bn_act(f"model.{2 + i}", width[i], width[i + 1], 3, 0.0, rout)
    first = 2 + n_downsampling
    for j in range(n_blocks):
        for half in ("conv1", "conv2"):
            spec += _ffc_bn_act(f"model.{first + j}.{half}", width[-1], width[-1], 3, ratio, ratio)
    at = first + n_blocks + 1  # after the concat
    for i in range(n_downsampling, 0, -1):
        cin, cout = width[i], width[i - 1]
        # a transposed stride-2 conv sums cin * 9 / 4 terms an output on average
        spec += [(f"model.{at}.weight", (cin, cout, 3, 3), ("he", cin * 9 / 4)),
                 (f"model.{at}.bias", (cout,), ("uniform", (cout * 9) ** -0.5))]
        spec += models._bn_spec(f"model.{at + 1}", cout)
        at += 3
    return spec + _conv(f"model.{at + 1}", ngf, 1, 7, bias=True)


# -- the layers ----------------------------------------------------------------

def _add(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if a is None:
        return b
    return a if b is None else a + b


def conv(p: Params, key: str, x: torch.Tensor, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """A convolution, reflect-padded by ``pad``."""
    if pad:
        x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    return models.conv2d(x, p[f"{key}.weight"], p.get(f"{key}.bias"), stride)


def bn_relu(p: Params, key: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    return torch.relu(models.batch_norm(p, key, x, train))


def fourier_unit(p: Params, key: str, u: torch.Tensor, train: bool) -> torch.Tensor:
    b, c, h, w = u.shape
    f = torch.fft.rfft2(u, norm="ortho")
    s = torch.stack([f.real, f.imag], 2).reshape(b, 2 * c, h, f.shape[-1])
    s = bn_relu(p, f"{key}.bn", conv(p, f"{key}.conv_layer", s), train)
    s = s.reshape(b, c, 2, h, f.shape[-1])
    return torch.fft.irfft2(torch.complex(s[:, :, 0], s[:, :, 1]), s=(h, w), norm="ortho")


def spectral_transform(p: Params, key: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    u = bn_relu(p, f"{key}.conv1.1", conv(p, f"{key}.conv1.0", x), train)
    return conv(p, f"{key}.conv2", u + fourier_unit(p, f"{key}.fu", u, train))


def ffc_bn_act(p: Params, key: str, x_l, x_g, stride: int, pad: int, train: bool):
    """FFC, then BN and ReLU on each branch: (y_l, y_g), None where absent."""
    def term(name, x):
        if x is None or f"{key}.ffc.{name}.weight" not in p:
            return None
        return conv(p, f"{key}.ffc.{name}", x, stride, pad)

    y_l = _add(term("convl2l", x_l), term("convg2l", x_g))
    st = None
    if x_g is not None and f"{key}.ffc.convg2g.conv2.weight" in p:
        st = spectral_transform(p, f"{key}.ffc.convg2g", x_g, train)
    y_g = _add(term("convl2g", x_l), st)
    return (None if y_l is None else bn_relu(p, f"{key}.bn_l", y_l, train),
            None if y_g is None else bn_relu(p, f"{key}.bn_g", y_g, train))


def layout(p: Params) -> Dict[str, List[int]]:
    """LaMa's ``model`` indices of the downsamplings and of the blocks."""
    idx = sorted({int(k.split(".")[1]) for k in p})
    return {"down": [i for i in idx if i >= 2 and f"model.{i}.ffc.convl2l.weight" in p],
            "blocks": [i for i in idx if f"model.{i}.conv1.ffc.convl2l.weight" in p]}


def generator(p: Params, image: torch.Tensor, mask: torch.Tensor, train: bool = False):
    """Big-LaMa on ``image * mask`` (NCHW, mask 1 = kept): the composite."""
    x = image * mask
    lay = layout(p)
    h = F.pad(torch.cat([x, 1.0 - mask], 1), (3, 3, 3, 3), mode="reflect")
    x_l, x_g = ffc_bn_act(p, "model.1", h, None, 1, 0, train)
    for i in lay["down"]:
        x_l, x_g = ffc_bn_act(p, f"model.{i}", x_l, x_g, 2, 1, train)
    for i in lay["blocks"]:
        y_l, y_g = ffc_bn_act(p, f"model.{i}.conv1", x_l, x_g, 1, 1, train)
        y_l, y_g = ffc_bn_act(p, f"model.{i}.conv2", y_l, y_g, 1, 1, train)
        x_l, x_g = x_l + y_l, x_g + y_g
    h = torch.cat([x_l, x_g], 1)
    at = lay["blocks"][-1] + 2
    for _ in lay["down"]:
        h = conv_transpose2d(h, p[f"model.{at}.weight"], p[f"model.{at}.bias"], stride=2,
                             padding=1, output_padding=1)
        h = bn_relu(p, f"model.{at + 1}", h, train)
        at += 3
    out = torch.sigmoid(conv(p, f"model.{at + 1}", h, pad=3))
    return out * (1.0 - mask) + x * mask


@torch.no_grad()
def eval_forward(p: Params, images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """NHWC float tiles and 0/1 masks -> the NHWC composite, BN on its
    running statistics."""
    return generator(p, nchw(images), nchw(masks), train=False).permute(0, 2, 3, 1)


class LamaTrainReference(TrainReference):
    """``TrainReference``'s GAN step (mode "gan" alone) with Big-LaMa as G."""

    def __init__(self, g: Params, vgg: Params, weights: Dict[str, float], lr: float,
                 d: Params):
        super().__init__("gan", g, vgg, weights, lr, d)

    def step(self, batch: Dict[str, torch.Tensor]) -> List[float]:
        real, mask = nchw(batch["image"]), nchw(batch["mask"])
        self.g_opt.zero_grad(set_to_none=True)
        gen = generator(self.g, real, mask, train=True)
        g_total = models.inpainting_loss(self.v, gen, real, mask, self.weights)
        g_total = g_total + models.bce_logits(models.discriminator(self.d, gen), 1.0)
        g_total.backward()
        self._record("generator", self.g)
        self.g_opt.step()
        self.d_opt.zero_grad(set_to_none=True)
        fake = gen.detach()
        d_loss = 0.5 * (models.bce_logits(models.discriminator(self.d, real), 1.0)
                        + models.bce_logits(models.discriminator(self.d, fake), 0.0))
        d_loss.backward()
        self._record("discriminator", self.d)
        self.d_opt.step()
        return [g_total.item(), d_loss.item()]

