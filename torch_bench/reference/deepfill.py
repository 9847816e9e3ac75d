"""Plain-PyTorch reference of DeepFill v2's generator, NCHW, float32.

Written from the published equations (Yu et al., ICCV 2019,
arXiv:1806.03589, and its contextual attention, CVPR 2018,
arXiv:1801.07892; github.com/JiahuiYu/generative_inpainting v2,
``inpaint_model.py`` ``build_inpaint_net``, ``inpaint_ops.py``
``gen_conv``, ``gen_deconv``, ``contextual_attention``), not from the
program under test, which it does not import. Functions take a flat
parameter dict under the published layer names (``conv1.weight``,
``pmconv6.bias``, ``allconv17.weight``, ...); ``cnum`` is read from
conv1's width.

  gen_conv(n, k, s, rate, act): TF "SAME" zero padding (total
        max((ceil(H/s) - 1) s + rate (k-1) + 1 - H, 0), its floor half
        before), conv k x k with bias and dilation rate; without act the
        output, else act(first half) * sigmoid(second half)
  gen_deconv(n): out[i] = in[i // 2] on both axes, then gen_conv(n, 3)
  stage 1 on [xin, 1, hole], xin = (2x - 1) m: conv1-17, x1 = tanh
  stage 2 on x1 hole + xin (1 - hole): xconv1-10 beside pmconv1-6,
        CA, pmconv9-10; concatenated; allconv11-17, x2 = tanh
  CA(f, b, hole): values = b's 4x4 patches at stride 2 (padding 1);
        queries = f[::2, ::2]'s 3x3 patches (padding 1), keys = b[::2,
        ::2]'s, each over max(its norm, 1e-4); S = Q K^T; fused twice,
        S[p, q] <- S[p-1, q-1] + S[p, q] + S[p+1, q+1] over the flat
        indices (zero outside), row-major, then column-major; mm[q] = 1
        where the key's 3x3 window of hole[::2, ::2] (zero outside) is
        all 0; A = softmax(10 S mm) mm; out = the values pasted at the
        queries' places, the adjoint of their extraction, over 4.

Every product goes through ``models.conv2d`` or this module's
``matmul``, so that ``precision`` sets the arithmetic of all of them: on
the CPU its "tf32" rounds their operands to TF32. The attention is
computed image by image: each [L, L] score matrix once at a time.

Departures from the published model, shared with the program's
contract: 3 input channels where DeepFill has 5, one output channel
where it has 3, the [0, 1] <-> [-1, 1] maps at the ends, each image's
own attention mask, no offset flow. The GAN step is this system's
objective (``reference.steps.TrainReference``'s) with DeepFill's coarse
L1 (weight 1, on x1 in [-1, 1] units) added to G's loss.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import models, steps
from .models import Params
from .steps import TrainReference, nchw

_MATMUL = torch.matmul
matmul = torch.matmul
SCALE, RATE, KSIZE = 10.0, 2, 3
COARSE_WEIGHT = 1.0

# (name, output channels, k, stride, rate, act) of each layer, in order;
# "up" is gen_deconv, act None the plain output conv
STAGE1 = ([("conv1", 1, 5, 1, 1, "elu"), ("conv2", 2, 3, 2, 1, "elu"),
           ("conv3", 2, 3, 1, 1, "elu"), ("conv4", 4, 3, 2, 1, "elu"),
           ("conv5", 4, 3, 1, 1, "elu"), ("conv6", 4, 3, 1, 1, "elu")]
          + [(f"conv{7 + i}", 4, 3, 1, 2 ** (i + 1), "elu") for i in range(4)]
          + [("conv11", 4, 3, 1, 1, "elu"), ("conv12", 4, 3, 1, 1, "elu"),
             ("conv13", 2, 3, "up", 1, "elu"), ("conv14", 2, 3, 1, 1, "elu"),
             ("conv15", 1, 3, "up", 1, "elu"), ("conv16", 0.5, 3, 1, 1, "elu"),
             ("conv17", None, 3, 1, 1, None)])
DILATED = ([("xconv1", 1, 5, 1, 1, "elu"), ("xconv2", 1, 3, 2, 1, "elu"),
            ("xconv3", 2, 3, 1, 1, "elu"), ("xconv4", 2, 3, 2, 1, "elu"),
            ("xconv5", 4, 3, 1, 1, "elu"), ("xconv6", 4, 3, 1, 1, "elu")]
           + [(f"xconv{7 + i}", 4, 3, 1, 2 ** (i + 1), "elu") for i in range(4)])
ATTENTION_IN = [("pmconv1", 1, 5, 1, 1, "elu"), ("pmconv2", 1, 3, 2, 1, "elu"),
                ("pmconv3", 2, 3, 1, 1, "elu"), ("pmconv4", 4, 3, 2, 1, "elu"),
                ("pmconv5", 4, 3, 1, 1, "elu"), ("pmconv6", 4, 3, 1, 1, "relu")]
ATTENTION_OUT = [("pmconv9", 4, 3, 1, 1, "elu"), ("pmconv10", 4, 3, 1, 1, "elu")]
MERGED = [("allconv11", 4, 3, 1, 1, "elu"), ("allconv12", 4, 3, 1, 1, "elu"),
          ("allconv13", 2, 3, "up", 1, "elu"), ("allconv14", 2, 3, 1, 1, "elu"),
          ("allconv15", 1, 3, "up", 1, "elu"), ("allconv16", 0.5, 3, 1, 1, "elu"),
          ("allconv17", None, 3, 1, 1, None)]


def _tf32_matmul(a, b):
    return _MATMUL(steps.tf32_round(a), steps.tf32_round(b))


@contextlib.contextmanager
def precision(name: str, device: torch.device):
    """``steps.precision`` for this reference: on the CPU its "tf32" also
    rounds the attention's products' operands."""
    global matmul
    with steps.precision(name, device):
        if name == "tf32" and device.type != "cuda":
            matmul = _tf32_matmul
        try:
            yield
        finally:
            matmul = _MATMUL


# -- parameter spec: (key, shape, init rule) as torch_bench/weights.py draws --

def layers(cnum: int):
    """(name, c_in, c_out of the conv, k, the tile's side over the conv's
    output side) of every conv, in the published order."""
    rows = []

    def walk(table, cin, div):
        for name, n, k, stride, _, act in table:
            div = div // 2 if stride == "up" else div * stride
            cout = 1 if n is None else int(n * cnum)
            rows.append((name, cin, cout, k, div))
            cin = cout if act is None else cout // 2
        return cin, div

    walk(STAGE1, 3, 1)
    branch, _ = walk(DILATED, 1, 1)
    attention, _ = walk(ATTENTION_OUT, *walk(ATTENTION_IN, 1, 1))
    walk(MERGED, branch + attention, 4)
    return rows


def generator_spec(cnum: int = 48):
    """Every tensor of the generator's state dict. Weights are normal with
    variance 3 x He's (6 / fan_in): a gated layer, ELU(f) sigmoid(g),
    keeps about a third of its input's second moment at He's scale, so
    17 of them in a row would leave x1 and x2 flat at 0 (RMS 0.03 after
    a stage, the fill's grey level spread by 0.005); at 3x the
    activations keep their size (RMS 0.6-1.0) through every stage, as
    He's scale does for ReLU layers. Biases are torch's default
    U(+-1/sqrt(fan_in))."""
    spec = []
    for name, cin, cout, k, _ in layers(cnum):
        fan_in = cin * k * k
        spec += [(f"{name}.weight", (cout, cin, k, k), ("he", fan_in / 3)),
                 (f"{name}.bias", (cout,), ("uniform", fan_in ** -0.5))]
    return spec


# -- the layers ----------------------------------------------------------------

def same_pad(size: int, k: int, stride: int, rate: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + rate * (k - 1) + 1 - size, 0)
    return total // 2, total - total // 2


def gen_conv(p: Params, name: str, x: torch.Tensor, stride: int, rate: int, act):
    w = p[f"{name}.weight"]
    k = w.shape[-1]
    top, bottom = same_pad(x.shape[-2], k, stride, rate)
    left, right = same_pad(x.shape[-1], k, stride, rate)
    y = models.conv2d(F.pad(x, (left, right, top, bottom)), w, p[f"{name}.bias"], stride, 0,
                      rate)
    if act is None:
        return y
    half = y.shape[1] // 2
    feature = F.elu(y[:, :half]) if act == "elu" else torch.relu(y[:, :half])
    return feature * torch.sigmoid(y[:, half:])


def upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def run_layers(p: Params, table, x: torch.Tensor) -> torch.Tensor:
    for name, _, _, stride, rate, act in table:
        if stride == "up":
            x, stride = upsample_nearest2(x), 1
        x = gen_conv(p, name, x, stride, rate, act)
    return x


def patches(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """[C, H, W] -> [positions, C k k]: the k x k windows of x padded by
    ``pad`` with zeros, at ``stride``, row-major positions, (c, u, v) inside."""
    c, h, w = x.shape
    xp = F.pad(x, (pad, pad, pad, pad))
    oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    cols = [xp[:, u : u + stride * (oh - 1) + 1 : stride, v : v + stride * (ow - 1) + 1 : stride]
            for u in range(k) for v in range(k)]
    return torch.stack(cols, 1).reshape(c * k * k, oh * ow).t()


def paste(values: torch.Tensor, c: int, h: int, w: int, k: int, stride: int,
          pad: int) -> torch.Tensor:
    """The adjoint of ``patches``: [positions, C k k] summed back into [C, H, W]."""
    oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    v = values.t().reshape(c, k, k, oh, ow)
    out = torch.zeros(c, h + 2 * pad, w + 2 * pad, dtype=values.dtype, device=values.device)
    for u in range(k):
        for t in range(k):
            out[:, u : u + stride * (oh - 1) + 1 : stride,
                t : t + stride * (ow - 1) + 1 : stride] += v[:, u, t]
    return out[:, pad : pad + h, pad : pad + w]


def fuse_flat(s: torch.Tensor) -> torch.Tensor:
    """S[p, q] <- S[p-1, q-1] + S[p, q] + S[p+1, q+1], zero outside [0, L)."""
    return (s + F.pad(s[:-1, :-1], (1, 0, 1, 0))) + F.pad(s[1:, 1:], (0, 1, 0, 1))


def fuse(s: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Both fuse passes over [L, L] scores of an h x w map: row-major flat
    indices (y w + x), then column-major (x h + y) on both sides."""
    s = fuse_flat(s)
    col = s.reshape(h, w, h, w).permute(1, 0, 3, 2).reshape(h * w, h * w)
    return fuse_flat(col).reshape(w, h, w, h).permute(1, 0, 3, 2).reshape(h * w, h * w)


def contextual_attention(f: torch.Tensor, b: torch.Tensor, hole: torch.Tensor) -> torch.Tensor:
    """CA of one image: f, b [C, H, W], hole [1, H, W] at their size."""
    c, h, w = b.shape
    values = patches(b, 2 * RATE, RATE, 1)  # [L, C 16]
    f_d, b_d, m_d = f[:, ::RATE, ::RATE], b[:, ::RATE, ::RATE], hole[:, ::RATE, ::RATE]
    hd, wd = f_d.shape[-2:]
    q = patches(f_d, KSIZE, 1, KSIZE // 2)
    keys = patches(b_d, KSIZE, 1, KSIZE // 2)
    norm = keys.square().sum(1, keepdim=True).sqrt()
    keys = keys / torch.maximum(norm, torch.full_like(norm, 1e-4))
    s = fuse(matmul(q, keys.t()), hd, wd)
    holes_seen = patches(m_d, KSIZE, 1, KSIZE // 2).sum(1)
    mm = (holes_seen == 0).to(s.dtype)[None, :]
    a = torch.softmax(SCALE * (s * mm), dim=1) * mm
    return paste(matmul(a, values), c, h, w, 2 * RATE, RATE, 1) / 4.0


def generator(p: Params, image: torch.Tensor, mask: torch.Tensor):
    """DeepFill v2 on ``image * mask`` (NCHW in [0, 1], mask 1 = kept):
    (the composite, the coarse stage's raw output x1 in [-1, 1])."""
    x, hole = image * mask, 1.0 - mask
    xin = (2.0 * image - 1.0) * mask
    x1 = torch.tanh(run_layers(p, STAGE1, torch.cat([xin, torch.ones_like(mask), hole], 1)))
    xs = x1 * hole + xin * (1.0 - hole)
    dilated = run_layers(p, DILATED, xs)
    pm = run_layers(p, ATTENTION_IN, xs)
    hole_s = hole[:, :, ::4, ::4]
    pm = torch.stack([contextual_attention(pm[i], pm[i], hole_s[i]) for i in range(len(pm))])
    pm = run_layers(p, ATTENTION_OUT, pm)
    x2 = torch.tanh(run_layers(p, MERGED, torch.cat([dilated, pm], 1)))
    y = (x2 + 1.0) / 2.0
    return y * (1.0 - mask) + x * mask, x1


def coarse_l1(x1: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """DeepFill's ae_loss on x1: mean |real - x1| in [-1, 1] units, all pixels."""
    return (2.0 * real - 1.0 - x1).abs().mean()


@torch.no_grad()
def eval_forward(p: Params, images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """NHWC float tiles and 0/1 masks -> the NHWC composite."""
    return generator(p, nchw(images), nchw(masks))[0].permute(0, 2, 3, 1)


class DeepFillTrainReference(TrainReference):
    """``TrainReference``'s GAN step (mode "gan" alone) with DeepFill v2 as
    G, its coarse L1 added to G's loss."""

    def __init__(self, g: Params, vgg: Params, weights: Dict[str, float], lr: float,
                 d: Params):
        super().__init__("gan", g, vgg, weights, lr, d)

    def step(self, batch: Dict[str, torch.Tensor]) -> List[float]:
        real, mask = nchw(batch["image"]), nchw(batch["mask"])
        self.g_opt.zero_grad(set_to_none=True)
        gen, x1 = generator(self.g, real, mask)
        g_total = models.inpainting_loss(self.v, gen, real, mask, self.weights)
        g_total = g_total + COARSE_WEIGHT * coarse_l1(x1, real)
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
