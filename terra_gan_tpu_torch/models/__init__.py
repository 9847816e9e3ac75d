"""Models of the port."""

from .discriminator import Discriminator
from .generator import PConv2d, PConvUNet
from .lama import FFCResNetGenerator
from .vgg import VGG16Features

__all__ = ["Discriminator", "FFCResNetGenerator", "PConv2d", "PConvUNet", "VGG16Features"]
