"""Models of the port."""

from .deepfill import DeepFillV2Generator
from .discriminator import Discriminator
from .generator import PConv2d, PConvUNet
from .lama import FFCResNetGenerator
from .vgg import VGG16Features

__all__ = ["DeepFillV2Generator", "Discriminator", "FFCResNetGenerator", "PConv2d", "PConvUNet",
           "VGG16Features"]
