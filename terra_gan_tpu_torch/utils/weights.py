"""Weights: from the JAX package, from a .pth, or from a seed.

Three generator architectures (``GENERATORS``, the config's
``model.generator``): the PConv U-Net ("pconv_unet", the default),
Big-LaMa's FFC ResNet ("big_lama", ``models/lama.py``) and DeepFill v2
("deepfill_v2", ``models/deepfill.py``). A state dict says which it is
by its keys, and a LaMa or DeepFill one its sizes by its shapes.

Generators come in eval mode, discriminators in train mode (the mode
the reference always runs them in); state dicts carry the reference's
torch keys and load with ``strict=True``. Conversion from the JAX
package's variables (numpy pytrees) goes through the port's own
``utils.torch_compat``. The VGG takes the JAX package's ``VGGParams``
(HWIO) or a seeded He-normal init.

Every constructor builds on the card unless the caller asks for the
CPU (``device="cpu"``); asking for the card where CUDA is absent raises
(``resolve_device``).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..config import GENERATORS
from ..models import deepfill
from ..models.deepfill import DEEPFILL_V2, DeepFillV2Generator, is_deepfill_state
from ..models.discriminator import Discriminator
from ..models.generator import PConvUNet
from ..models.lama import BIG_LAMA, FFCResNetGenerator, is_lama_state, sizes_from_state
from ..models.vgg import (
    CONV_CHANNELS,
    VGG16Features,
    vgg_state_from_hwio,
    vgg_state_from_torchvision,
)
from .device import resolve_device
from .torch_compat import discriminator_vars_to_torch_state, generator_vars_to_torch_state


def _load_state(model: torch.nn.Module, sd: Mapping[str, Any], device) -> torch.nn.Module:
    state = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}
    model.load_state_dict(state, strict=True)
    return model.to(resolve_device(device))


def generator_from_jax_variables(
    variables: Mapping[str, Any], base_width: int = 64, device="cuda"
) -> PConvUNet:
    """The JAX package's generator variables (numpy arrays) as a port PConvUNet."""
    sd = generator_vars_to_torch_state(variables)
    return _load_state(PConvUNet(base_width), sd, device).eval()


def generator_architecture(state: Mapping[str, Any]) -> str:
    """The ``GENERATORS`` name of a generator state dict, by its keys."""
    if is_lama_state(state):
        return "big_lama"
    return "deepfill_v2" if is_deepfill_state(state) else "pconv_unet"


def load_generator(path: str | Path, device="cuda") -> torch.nn.Module:
    """A generator from a reference-layout .pth.

    Accepts a master dict (``generator_state_dict``), a human-guided
    trainer dict (``model_state_dict``) or a raw state dict, as the JAX
    package's ``load_generator_variables`` does. A PConvUNet's width
    comes from ``enc1.input_conv.weight``; a LaMa state dict (LaMa's
    ``model.*`` keys) gives an FFCResNetGenerator of its sizes, a
    DeepFill one (its published layer names) a DeepFillV2Generator.
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "generator_state_dict" in obj:
        sd = obj["generator_state_dict"]
    elif isinstance(obj, dict) and "model_state_dict" in obj:
        sd = obj["model_state_dict"]
    else:
        sd = obj
    if is_lama_state(sd):
        return _load_state(FFCResNetGenerator(**sizes_from_state(sd)), sd, device).eval()
    if is_deepfill_state(sd):
        return _load_state(DeepFillV2Generator(**deepfill.sizes_from_state(sd)), sd,
                           device).eval()
    width = int(sd["enc1.input_conv.weight"].shape[0])
    return _load_state(PConvUNet(width), sd, device).eval()


def init_generator(
    base_width: int, generator: torch.Generator, device="cuda", arch: str = "pconv_unet"
) -> torch.nn.Module:
    """A generator with random weights drawn from ``generator`` (a CPU generator).

    ``arch`` "pconv_unet": a PConvUNet of ``base_width``; "big_lama": an
    FFCResNetGenerator with ``ngf = base_width`` and Big-LaMa's other
    sizes (``BIG_LAMA``); "deepfill_v2": a DeepFillV2Generator at its
    published sizes (``DEEPFILL_V2``, ``cnum`` 48), whatever
    ``base_width``, which is the other two's width. Convolutions get
    torch's default init, U(+-1/sqrt(fan_in)) for weight and bias. The BatchNorm parameters
    and running statistics are drawn too (gamma in [0.5, 1.5), beta and
    the mean from N(0, 0.1^2), the variance in [0.5, 1.5)), so that an
    eval forward exercises the folded BatchNorm. The values depend only
    on the seed, not on the device.
    """
    if arch == "big_lama":
        model = FFCResNetGenerator(**{**BIG_LAMA, "ngf": base_width})
    elif arch == "deepfill_v2":
        model = DeepFillV2Generator(**DEEPFILL_V2)
    elif arch == "pconv_unet":
        model = PConvUNet(base_width)
    else:
        raise ValueError(f"unknown generator {arch!r}: one of {GENERATORS}")
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                _torch_default_init(mod, generator)
            elif isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.uniform_(0.5, 1.5, generator=generator)
                mod.bias.normal_(0.0, 0.1, generator=generator)
                mod.running_mean.normal_(0.0, 0.1, generator=generator)
                mod.running_var.uniform_(0.5, 1.5, generator=generator)
    return model.to(resolve_device(device)).eval()


def _torch_default_init(conv: torch.nn.Module, generator: torch.Generator) -> None:
    """torch's default conv init, U(+-1/sqrt(fan_in)) for weight and bias
    (where it has one), from ``generator``."""
    bound = 1.0 / math.sqrt(conv.weight[0].numel())
    conv.weight.uniform_(-bound, bound, generator=generator)
    if conv.bias is not None:
        conv.bias.uniform_(-bound, bound, generator=generator)


def discriminator_from_jax_variables(
    variables: Mapping[str, Any], base_width: int = 64, device="cuda"
) -> Discriminator:
    """The JAX package's discriminator variables (numpy arrays) as a port Discriminator."""
    sd = discriminator_vars_to_torch_state(variables)
    return _load_state(Discriminator(base_width), sd, device)


def init_discriminator(
    base_width: int, generator: torch.Generator, device="cuda"
) -> Discriminator:
    """A Discriminator with torch's default conv init drawn from ``generator``
    (a CPU generator) and fresh BatchNorm (ones, zeros; statistics 0 and 1)."""
    model = Discriminator(base_width)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                _torch_default_init(mod, generator)
    return model.to(resolve_device(device))


def vgg_from_jax_params(params: Sequence[Tuple[Any, Any]], device="cuda") -> VGG16Features:
    """The JAX package's ``VGGParams`` (e.g. ``random_weights(0)``) as a port VGG."""
    return _load_state(VGG16Features(), vgg_state_from_hwio(params), device)


def init_vgg(generator: torch.Generator, device="cuda") -> VGG16Features:
    """A VGG with seeded He-normal conv weights and zero biases, the
    counterpart of the JAX package's ``random_weights`` (vgg.py:52-65); torch
    draws other numbers from the same seed, so the tests carry JAX's across."""
    model = VGG16Features()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
                mod.bias.zero_()
    return model.to(resolve_device(device))


def load_vgg(path: str | Path, device="cuda") -> VGG16Features:
    """VGG weights from a file, as the JAX package's ``vgg.load_weights`` reads
    them: an ``.npz`` of HWIO ``conv{i}_kernel`` / ``conv{i}_bias``, or a
    torchvision VGG16 state dict (whole, or its features alone)."""
    if str(path).endswith(".npz"):
        with np.load(path) as data:
            return vgg_from_jax_params(
                [(data[f"conv{i}_kernel"], data[f"conv{i}_bias"])
                 for i in range(len(CONV_CHANNELS))], device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = VGG16Features()
    model.load_state_dict(vgg_state_from_torchvision(sd), strict=True)
    return model.to(resolve_device(device))
