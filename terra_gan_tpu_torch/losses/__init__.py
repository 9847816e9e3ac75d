"""Losses of the port."""

from .inpainting import (
    HumanGuidedLossConfig,
    InpaintingLossConfig,
    boundary_aware_loss,
    boundary_band,
    human_guided_loss,
    inpainting_loss,
    l1_loss,
    total_variation_loss,
)

__all__ = [
    "HumanGuidedLossConfig", "InpaintingLossConfig", "boundary_aware_loss", "boundary_band",
    "human_guided_loss", "inpainting_loss", "l1_loss", "total_variation_loss",
]
