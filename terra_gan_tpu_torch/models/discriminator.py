"""PatchGAN discriminator (counterpart of terra_gan_tpu/models/discriminator.py).

The reference's ``nn.Sequential`` (mvp_gan/src/models/discriminator.py:
10-26), kept as ``model`` so the state-dict keys are the reference's:
four conv k4 s2 p1 blocks of widths w, 2w, 4w, 8w (``model.{0,2,5,8}``),
BatchNorm on blocks 1-3 (``model.{3,6,9}``), LeakyReLU 0.2, then a
k4 s1 p1 conv to one logit (``model.11``). NHWC in, NHWC logits
[B, H/16 - 1, W/16 - 1, 1] out.
"""

from __future__ import annotations

import torch
from torch import nn


class Discriminator(nn.Module):
    def __init__(self, base_width: int = 64):
        super().__init__()
        w = base_width
        layers = [nn.Conv2d(1, w, 4, 2, 1), nn.LeakyReLU(0.2)]
        for cin, cout in ((w, 2 * w), (2 * w, 4 * w), (4 * w, 8 * w)):
            layers += [nn.Conv2d(cin, cout, 4, 2, 1), nn.BatchNorm2d(cout), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(8 * w, 1, 4, 1, 1))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
