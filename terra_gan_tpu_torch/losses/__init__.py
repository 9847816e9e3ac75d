"""Losses of the port."""

from .inpainting import (
    InpaintingLossConfig,
    boundary_aware_loss,
    boundary_band,
    inpainting_loss,
    l1_loss,
    total_variation_loss,
)

__all__ = [
    "InpaintingLossConfig", "boundary_aware_loss", "boundary_band",
    "inpainting_loss", "l1_loss", "total_variation_loss",
]
