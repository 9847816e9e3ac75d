"""Plain-PyTorch reference of the PConv U-Net GAN, NCHW, float32.

Written from the published model, not from the program under test:
mvp_gan/src/models/{pconv,generator,discriminator}.py of
https://github.com/FKGSOFTWARE/TERRA-GAN and its losses
(mvp_gan/src/utils/losses.py), with torchvision's VGG16 features[:16].
Nothing here imports the program or any kernel of it; every function
takes a flat parameter dict keyed by the reference's state-dict names.

Departures from the reference, all shared with the program's contract:
the mask is one channel broadcast over the features, and the partial
conv keeps the reference's bias inside the renormalisation.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# every convolution goes through this name, so that a precision can be set
# for all of them (steps.precision)
conv2d = F.conv2d

# (name, c_in, c_out, k, stride) of the generator's partial-conv stages
def generator_stages(w: int) -> List[Tuple[str, int, int, int, int]]:
    enc = [(1, w, 7), (w, 2 * w, 5), (2 * w, 4 * w, 5), (4 * w, 8 * w, 3),
           (8 * w, 8 * w, 3), (8 * w, 8 * w, 3), (8 * w, 8 * w, 3)]
    dec = [(7, 16 * w, 8 * w), (6, 16 * w, 8 * w), (5, 16 * w, 8 * w), (4, 12 * w, 4 * w),
           (3, 6 * w, 2 * w), (2, 3 * w, w), (1, w, w)]
    return ([(f"enc{i + 1}", ci, co, k, 2) for i, (ci, co, k) in enumerate(enc)]
            + [(f"dec{n}", ci, co, 3, 1) for n, ci, co in dec])


def discriminator_convs(w: int) -> List[Tuple[str, int, int, int, int, bool]]:
    """(conv key, c_in, c_out, stride, padding, followed by BatchNorm) of PatchGAN."""
    return [("model.0", 1, w, 2, 1, False), ("model.2", w, 2 * w, 2, 1, True),
            ("model.5", 2 * w, 4 * w, 2, 1, True), ("model.8", 4 * w, 8 * w, 2, 1, True),
            ("model.11", 8 * w, 1, 1, 1, False)]


VGG_CONVS = [("features.0", 3, 64), ("features.2", 64, 64), ("features.5", 64, 128),
             ("features.7", 128, 128), ("features.10", 128, 256), ("features.12", 256, 256),
             ("features.14", 256, 256)]
VGG_POOL_AFTER = ("features.2", "features.7")


# -- parameter specs: (key, shape, init) in the reference's state-dict order --

def _conv_spec(key: str, cin: int, cout: int, k: int, bias: bool = True):
    fan_in = cin * k * k
    out = [(f"{key}.weight", (cout, cin, k, k), ("he", fan_in))]
    if bias:
        out.append((f"{key}.bias", (cout,), ("uniform", fan_in ** -0.5)))
    return out


def _bn_spec(key: str, c: int):
    return [(f"{key}.weight", (c,), ("gamma",)), (f"{key}.bias", (c,), ("beta",)),
            (f"{key}.running_mean", (c,), ("beta",)), (f"{key}.running_var", (c,), ("gamma",)),
            (f"{key}.num_batches_tracked", (), ("zero_long",))]


def generator_spec(w: int):
    spec = []
    for name, ci, co, k, _ in generator_stages(w):
        spec += _conv_spec(f"{name}.input_conv", ci, co, k)
        spec.append((f"{name}.mask_conv.weight", (1, 1, k, k), ("ones",)))
        spec += _bn_spec(f"{name}.bn", co)
    spec += _conv_spec("final", w, 1, 3)
    return spec


def discriminator_spec(w: int):
    spec = []
    for i, (key, ci, co, _, _, bn) in enumerate(discriminator_convs(w)):
        spec += _conv_spec(key, ci, co, 4)
        if bn:
            spec += _bn_spec(f"model.{int(key.split('.')[1]) + 1}", co)
    return spec


def vgg_spec():
    spec = []
    for key, ci, co in VGG_CONVS:
        spec += _conv_spec(key, ci, co, 3)
    return spec


SPECS = {"generator": generator_spec, "discriminator": discriminator_spec,
         "vgg": lambda w: vgg_spec()}


# -- the layers --------------------------------------------------------------

def batch_norm(p: Params, key: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    return F.batch_norm(x, p[f"{key}.running_mean"], p[f"{key}.running_var"],
                        p[f"{key}.weight"], p[f"{key}.bias"], training=train,
                        momentum=0.1, eps=1e-5)


def partial_conv(p: Params, name: str, x, m, stride: int, train: bool):
    """pconv.py:25-50: conv(x * m) with the bias inside the renormalisation
    k*k / (window sum of the mask + 1e-8), zero where the window saw no
    valid pixel; then BatchNorm and ReLU. Returns (features, new mask)."""
    w = p[f"{name}.input_conv.weight"]
    k = w.shape[-1]
    out = conv2d(x * m, w, None, stride, k // 2)
    ones = torch.ones(1, 1, k, k, dtype=m.dtype, device=m.device)
    msum = conv2d(m, ones, None, stride, k // 2)
    valid = msum > 0
    ratio = torch.where(valid, (k * k) / (msum + 1e-8), torch.zeros_like(msum))
    out = (out + p[f"{name}.input_conv.bias"].view(1, -1, 1, 1)) * ratio
    out = batch_norm(p, f"{name}.bn", out, train)
    return torch.relu(out), valid.to(m.dtype)


def generator(p: Params, image: torch.Tensor, mask: torch.Tensor, train: bool = False,
              taps: Dict[str, torch.Tensor] | None = None) -> torch.Tensor:
    """The U-Net on ``image * mask`` (NCHW, mask 1 = kept): the composite.
    ``taps`` receives dec2's features."""
    x = image * mask
    feats, masks = [x], [mask]
    h, m = x, mask
    for i in range(1, 8):
        h, m = partial_conv(p, f"enc{i}", h, m, 2, train)
        feats.append(h)
        masks.append(m)
    for n in range(7, 1, -1):
        up = F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=False)
        up_m = F.interpolate(m, scale_factor=2, mode="nearest")
        skip, skip_m = feats[n - 1], masks[n - 1]
        if up.shape[-2:] != skip.shape[-2:]:
            raise ValueError("the reference takes sizes that halve evenly 7 times")
        h, m = partial_conv(p, f"dec{n}", torch.cat([up, skip], 1),
                            torch.maximum(up_m, skip_m), 1, train)
    if taps is not None:
        taps["dec2"] = h
    up = F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=False)
    up_m = F.interpolate(m, scale_factor=2, mode="nearest")
    h, _ = partial_conv(p, "dec1", up, torch.maximum(up_m, mask), 1, train)
    out = torch.sigmoid(conv2d(h, p["final.weight"], p["final.bias"], padding=1))
    return out * (1.0 - mask) + x * mask


def discriminator(p: Params, x: torch.Tensor) -> torch.Tensor:
    """PatchGAN logits (discriminator.py:10-26), BatchNorm on the batch."""
    for key, _, _, stride, pad, bn in discriminator_convs(p["model.0.weight"].shape[0]):
        x = conv2d(x, p[f"{key}.weight"], p[f"{key}.bias"], stride, pad)
        if key == "model.11":
            return x
        if bn:
            x = batch_norm(p, f"model.{int(key.split('.')[1]) + 1}", x, True)
        x = F.leaky_relu(x, 0.2)
    raise AssertionError("unreachable")


def vgg(p: Params, x: torch.Tensor) -> torch.Tensor:
    """VGG16 features[:16] on the one-channel map repeated to three."""
    x = x.expand(-1, 3, -1, -1)
    for key, _, _ in VGG_CONVS:
        x = torch.relu(conv2d(x, p[f"{key}.weight"], p[f"{key}.bias"], padding=1))
        if key in VGG_POOL_AFTER:
            x = F.max_pool2d(x, 2, 2)
    return x


# -- losses (mvp_gan/src/utils/losses.py) -----------------------------------

def boundary_loss(pred, target, mask):
    """Area-normalised L1 on the band between the 3x3 dilation and erosion
    of the mask; 0 when the band is empty (losses.py:403-416)."""
    dil = F.max_pool2d(mask, 3, 1, 1)
    ero = 1.0 - F.max_pool2d(1.0 - mask, 3, 1, 1)
    band = (dil - ero).clamp(0.0, 1.0)
    area = band.sum()
    loss = ((pred - target).abs() * band).sum() / (area + 1e-6)
    return torch.where(area < 1.0, torch.zeros_like(loss), loss)


def tv_loss(x):
    dh = x[:, :, 1:] - x[:, :, :-1]
    dw = x[:, :, :, 1:] - x[:, :, :, :-1]
    return 2.0 * (dh.square().sum() / dh.numel() + dw.square().sum() / dw.numel()) / x.shape[0]


def inpainting_loss(vp: Params, pred, target, mask, w: Dict[str, float]):
    """L1 + perceptual * L1(VGG) + tv * TV(holes) + boundary * band L1."""
    with torch.no_grad():
        feat_t = vgg(vp, target)
    total = (pred - target).abs().mean()
    total = total + w["perceptual"] * (vgg(vp, pred) - feat_t).abs().mean()
    total = total + w["tv"] * tv_loss(pred * (1.0 - mask))
    return total + w["boundary"] * boundary_loss(pred, target, mask)


def human_guided_loss(vp: Params, pred, target, mask, human, w: Dict[str, float]):
    """losses.py:152-204: base * InpaintingLoss + human * (L1 on the human
    regions + boundary * band L1 of the regions), the human term 0 when
    the regions are empty."""
    base = inpainting_loss(vp, pred, target, mask, w)
    regions = (human > 0).float()
    term = (pred * regions - target * regions).abs().mean()
    term = term + w["boundary"] * boundary_loss(pred, target, regions)
    term = torch.where(regions.sum() > 0, term, torch.zeros_like(term))
    return w["base_loss_weight"] * base + w["human_feedback_weight"] * term


def bce_logits(logits, target: float):
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))
