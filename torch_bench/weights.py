"""Seeded weights for a configuration, made on the device in a few large draws.

Each tensor of a spec (reference.models.SPECS) is drawn by its rule:
  he       normal, std sqrt(2 / fan_in): the scale at which ReLU layers
           keep their activations' size through 14 stages, so the output
           in the holes spreads over the grey range as a trained model's
           does (with torch's default uniform init it sits at 0.5 +- 0.003
           and the uint8 answer is blind to the arithmetic);
  uniform  U(-b, b), b = 1 / sqrt(fan_in): the conv biases, torch's default;
  gamma    U(0.5, 1.5): BatchNorm scales and running variances;
  beta     N(0, 0.1^2): BatchNorm shifts and running means;
  ones, zero_long: the frozen mask convs and the BatchNorm step counts.
The same seed gives the same tensors on the same kind of device.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.models import SPECS


def seeded_state(kind: str, width: int, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The state dict of ``kind`` ("generator", "discriminator", "vgg") at
    ``width``, drawn from ``seed`` with a generator on ``device``."""
    spec = SPECS[kind](width)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 4 + ("generator", "discriminator", "vgg").index(kind)) % 2**63)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (key, shape, rule), n in zip(spec, sizes):
        z, u = normal[at : at + n].view(shape), uniform[at : at + n].view(shape)
        at += n
        if rule[0] == "he":
            t = z * math.sqrt(2.0 / rule[1])
        elif rule[0] == "uniform":
            t = (2.0 * u - 1.0) * rule[1]
        elif rule[0] == "gamma":
            t = 0.5 + u
        elif rule[0] == "beta":
            t = 0.1 * z
        elif rule[0] == "ones":
            t = torch.ones(shape, device=device)
        elif rule[0] == "zero_long":
            t = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            raise ValueError(f"unknown init rule {rule}")
        out[key] = t.clone()
    return out
