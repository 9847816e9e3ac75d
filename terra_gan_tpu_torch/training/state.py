"""GAN training state (counterpart of terra_gan_tpu/training/state.py).

The reference keeps a generator and a discriminator with an Adam each
(main_pipeline.py:208-221, train.py:137-147). Here they are one object:
both modules, both ``torch.optim.Adam`` built over ``.parameters()`` (so
the optimizer state is numbered in the reference's parameter order, the
frozen mask convs included), and the count of steps taken. The step
updates it in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from torch import nn

from ..config import LoopConfig
from ..models.discriminator import Discriminator


def adam(params, lr: float) -> torch.optim.Adam:
    """torch.optim.Adam with the reference's settings (betas 0.9/0.999, eps 1e-8)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@dataclass
class GANTrainState:
    generator: nn.Module  # PConvUNet, FFCResNetGenerator or DeepFillV2Generator
    discriminator: Discriminator
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0

    @classmethod
    def create(
        cls,
        generator: nn.Module,
        discriminator: Discriminator,
        lr: float = LoopConfig.learning_rate,
    ) -> "GANTrainState":
        """Both networks in train mode, on the device they are on, with fresh
        Adams (``train`` sets their rate to its config's)."""
        g_dev = next(generator.parameters()).device
        d_dev = next(discriminator.parameters()).device
        if g_dev != d_dev:
            raise ValueError(f"generator on {g_dev}, discriminator on {d_dev}: one device")
        return cls(
            generator=generator.train(),
            discriminator=discriminator.train(),
            g_opt=adam(generator.parameters(), lr),
            d_opt=adam(discriminator.parameters(), lr),
        )

    @property
    def device(self) -> torch.device:
        return next(self.generator.parameters()).device
