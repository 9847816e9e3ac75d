"""Models of the port."""

from .discriminator import Discriminator
from .generator import PConv2d, PConvUNet
from .vgg import VGG16Features

__all__ = ["Discriminator", "PConv2d", "PConvUNet", "VGG16Features"]
