"""The reference's forward and train steps, in plain PyTorch float32.

``precision`` selects the arithmetic of the convolutions: "fp32" (TF32
off), or "tf32", the precision one step below, which is the control that
the comparison has to reject. On a card "tf32" turns cuDNN's TF32 on; on
the CPU, where there is none, every convolution's operands are rounded
to TF32 (10 mantissa bits) and the products summed in float32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
import torch.nn.functional as F

from . import models
from .models import Params


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (low 13 mantissa bits zero);
    the gradient passes through unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    return x + (((bits + 0x1000) & ~0x1FFF).view(torch.float32) - x).detach()


def _tf32_conv2d(x, w, b=None, stride=1, padding=0, *args):
    return _CONV2D(tf32_round(x), tf32_round(w), b, stride, padding, *args)


_CONV2D = F.conv2d


@contextlib.contextmanager
def precision(name: str, device: torch.device):
    """The convolutions' arithmetic while open: "fp32" or "tf32"."""
    if name not in ("fp32", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    tf32 = name == "tf32"
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    emulate = tf32 and device.type != "cuda"
    if emulate:
        models.conv2d = _tf32_conv2d
    try:
        yield
    finally:
        if emulate:
            models.conv2d = _CONV2D
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def nchw(a) -> torch.Tensor:
    return a.permute(0, 3, 1, 2)


@torch.no_grad()
def eval_forward(p: Params, images_u8: torch.Tensor, masks_u8: torch.Tensor):
    """uint8 NHWC tiles and 0/255 masks on the device -> (uint8 composite
    NHWC, quantised as the program's output is: clamp(0, 1) * 255 truncated;
    dec2's features NHWC)."""
    image = nchw(images_u8).float() / torch.full((), 255.0, device=images_u8.device)
    mask = (nchw(masks_u8) > 0).float()
    taps: Dict[str, torch.Tensor] = {}
    out = models.generator(p, image, mask, train=False, taps=taps)
    u8 = (out.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return u8.permute(0, 2, 3, 1), taps["dec2"].permute(0, 2, 3, 1)


def trainable(key: str) -> bool:
    return key.endswith((".weight", ".bias")) and ".mask_conv." not in key


class TrainReference:
    """G (and D) with their Adams, stepped on given batches.

    ``mode`` "gan": the G step (InpaintingLoss + BCE(D(gen), 1)) and the D
    step (0.5 * (BCE(D(real), 1) + BCE(D(gen from before G's update), 0))),
    both Adams at ``lr``. "hg": G alone on HumanGuidedLoss. Parameters are
    clones: nothing is shared with the caller.
    """

    def __init__(self, mode: str, g: Params, vgg: Params, weights: Dict[str, float], lr: float,
                 d: Params | None = None):
        self.mode, self.weights = mode, weights
        self.g = {k: v.detach().clone().requires_grad_(trainable(k)) for k, v in g.items()}
        self.v = {k: v.detach().clone() for k, v in vgg.items()}
        self.d = None if d is None else {
            k: v.detach().clone().requires_grad_(trainable(k)) for k, v in d.items()}
        adam = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.g_opt = torch.optim.Adam([v for v in self.g.values() if v.requires_grad], **adam)
        self.d_opt = None if d is None else torch.optim.Adam(
            [v for v in self.d.values() if v.requires_grad], **adam)
        self.grads: Dict[str, Dict[str, torch.Tensor]] = {}

    def _record(self, name: str, params: Params) -> None:
        if name not in self.grads:  # the first step's gradients
            self.grads[name] = {k: v.grad.detach().clone() for k, v in params.items()
                                if v.requires_grad and v.grad is not None}

    def step(self, batch: Dict[str, torch.Tensor]) -> List[float]:
        """One step on an NHWC float batch ({'image', 'mask'[, 'human_mask']});
        returns the step's losses: [g_loss, d_loss] or [loss]."""
        real, mask = nchw(batch["image"]), nchw(batch["mask"])
        self.g_opt.zero_grad(set_to_none=True)
        gen = models.generator(self.g, real, mask, train=True)
        if self.mode == "hg":
            loss = models.human_guided_loss(self.v, gen, real, mask, nchw(batch["human_mask"]),
                                            self.weights)
            loss.backward()
            self._record("generator", self.g)
            self.g_opt.step()
            return [loss.item()]
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

    def params(self, name: str) -> Params:
        return self.g if name == "generator" else self.d
