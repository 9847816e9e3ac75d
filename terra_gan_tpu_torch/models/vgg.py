"""VGG16 ``features[:16]`` for the perceptual loss (counterpart of terra_gan_tpu/models/vgg.py).

The reference computes its perceptual loss on torchvision's VGG16
``features[:16]`` applied to the 1-channel DSM repeated to 3 channels
(mvp_gan/src/utils/losses.py:31-32, 79-89): conv1_1 .. conv3_3 and
their ReLUs, with max-pools after conv1_2 and conv2_2. The module keeps
torchvision's layer indices under ``features``, so a torchvision VGG16
state dict loads as it is. The weights are frozen: the loss needs the
gradient with respect to the input only.

The channel repeat is literal, as in the JAX package's parity mode
(vgg.py:107-126). The pretrained IMAGENET1K_V1 weights need a download;
``utils.weights`` gives a seeded He-normal init and the JAX package's
``random_weights`` carried across.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

CONV_CHANNELS = (64, 64, 128, 128, 256, 256, 256)
TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14)  # torchvision features.* indices
_POOL_AFTER = (1, 3)  # conv1_2 and conv2_2


class VGG16Features(nn.Module):
    """x [B,H,W,C] -> the conv3_3 post-ReLU map [B, H/4, W/4, 256]; C = 1 is repeated to 3."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for i, cout in enumerate(CONV_CHANNELS):
            layers += [nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU()]
            if i in _POOL_AFTER:
                layers.append(nn.MaxPool2d(2, 2))
            cin = cout
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == 1:
            x = x.expand(-1, -1, -1, 3)
        return self.features(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def vgg_state_from_hwio(params: Sequence[Tuple[Any, Any]]) -> dict:
    """The JAX package's ``VGGParams`` (HWIO kernel, bias) as this module's state dict."""
    sd = {}
    for idx, (kernel, bias) in zip(TORCH_CONV_IDX, params, strict=True):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1))
        )
        sd[f"features.{idx}.bias"] = torch.from_numpy(np.array(bias, copy=True))
    return sd


def vgg_state_from_torchvision(sd: Mapping[str, Any]) -> dict:
    """A torchvision VGG16 state dict (``features.N.*``), or its features alone
    (``N.*``), cut to this module's layers."""
    prefix = "features." if any(k.startswith("features.") for k in sd) else ""
    return {
        f"features.{idx}.{leaf}": torch.as_tensor(sd[f"{prefix}{idx}.{leaf}"])
        for idx in TORCH_CONV_IDX
        for leaf in ("weight", "bias")
    }
