"""Inpainting loss stack (counterpart of terra_gan_tpu/losses/inpainting.py).

NHWC tensors, the reference's numerics (mvp_gan/src/utils/losses.py):

  * InpaintingLoss = L1(full image)
      + perceptual_weight * L1(VGG16 features[:16] of pred vs target)
      + tv_weight * TV(pred * hole_mask)
      + boundary_weight * boundary(pred, target, mask)
    (losses.py:58-116);
  * TV is the reference's formula: the sums of squared neighbour
    differences, each over its element count, x2, over the batch
    (losses.py:118-127);
  * the boundary term is an area-normalised L1 on the band between a
    fixed 3x3 dilation and erosion of the mask, exactly 0 when the band
    is empty (losses.py:403-416);
  * HumanGuidedLoss = base_loss_weight * InpaintingLoss
      + human_feedback_weight * (L1 on the human-mask regions
                                 + boundary_weight * boundary(regions))
    where the human term is exactly 0 when the regions are empty
    (losses.py:152-204).

The target's VGG features carry no gradient (the JAX package's
stop_gradient), so they are computed under ``torch.no_grad()``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.vgg import VGG16Features

_EPS_BOUNDARY = 1e-6


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over all elements (torch nn.L1Loss default)."""
    return (a - b).abs().mean()


def total_variation_loss(x: torch.Tensor) -> torch.Tensor:
    """Reference TV formula (losses.py:118-127). x: [B, H, W, C]."""
    h_diff = x[:, 1:] - x[:, :-1]
    w_diff = x[:, :, 1:] - x[:, :, :-1]
    h_tv = h_diff.square().sum() / h_diff.numel()
    w_tv = w_diff.square().sum() / w_diff.numel()
    return 2.0 * (h_tv + w_tv) / x.shape[0]


def _max_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)


def boundary_band(mask: torch.Tensor) -> torch.Tensor:
    """3x3 dilation minus erosion, clamped to [0, 1] (losses.py:406-408).

    mask: [B, H, W, 1], 1 = preserved. max_pool2d pads with -inf, so the
    edge windows see only real values, as in the reference.
    """
    dilated = _max_pool_3x3(mask)
    eroded = 1.0 - _max_pool_3x3(1.0 - mask)
    return (dilated - eroded).clamp(0.0, 1.0)


def boundary_aware_loss(
    pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Area-normalised L1 on the mask boundary band (losses.py:403-416)."""
    band = boundary_band(mask)
    band_sum = band.sum()
    loss = ((pred - target).abs() * band).sum() / (band_sum + _EPS_BOUNDARY)
    # the reference returns exactly 0 when the band is empty (sum < 1);
    # a select, not a branch, so the device is not synchronised
    return torch.where(band_sum < 1.0, torch.zeros_like(loss), loss)


@dataclass
class InpaintingLossConfig:
    perceptual_weight: float = 0.1
    tv_weight: float = 0.1
    boundary_weight: float = 0.5  # the reference's default (losses.py:14)


def inpainting_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    vgg: Optional[VGG16Features],
    config: InpaintingLossConfig = InpaintingLossConfig(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full inpainting loss: (total, components). pred/target [B,H,W,1] in
    [0, 1]; mask [B,H,W,1], 1 = preserved. Components: l1, perceptual (with
    a VGG and a positive weight), tv, boundary, total."""
    comps: Dict[str, torch.Tensor] = {"l1": l1_loss(pred, target)}
    total = comps["l1"]
    if config.perceptual_weight > 0 and vgg is not None:
        feat_pred = vgg(pred)
        with torch.no_grad():
            feat_target = vgg(target)
        comps["perceptual"] = l1_loss(feat_pred, feat_target)
        total = total + config.perceptual_weight * comps["perceptual"]
    if config.tv_weight > 0:
        comps["tv"] = total_variation_loss(pred * (1.0 - mask))
        total = total + config.tv_weight * comps["tv"]
    if config.boundary_weight > 0:
        comps["boundary"] = boundary_aware_loss(pred, target, mask)
        total = total + config.boundary_weight * comps["boundary"]
    comps["total"] = total
    return total, comps


@dataclass
class HumanGuidedLossConfig:
    base: InpaintingLossConfig = field(default_factory=InpaintingLossConfig)
    base_loss_weight: float = 0.7
    human_feedback_weight: float = 0.3


def human_guided_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    human_mask: Optional[torch.Tensor],
    vgg: Optional[VGG16Features],
    config: HumanGuidedLossConfig = HumanGuidedLossConfig(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """HumanGuidedLoss (losses.py:152-204): (total, components). human_mask
    [B,H,W,1] or None; its regions are ``human_mask > 0``. Components: those
    of ``inpainting_loss``, base (its total), human and total."""
    base_total, comps = inpainting_loss(pred, target, mask, vgg, config.base)
    comps["base"] = base_total
    human = torch.zeros((), dtype=pred.dtype, device=pred.device)
    if human_mask is not None:
        # float32 0/1 planes, as the JAX package builds them: the boundary
        # term's area then sums (and adds its epsilon) in float32 whatever
        # the prediction's type
        regions = (human_mask > 0).float()
        human_term = l1_loss(pred * regions, target * regions)
        if config.base.boundary_weight > 0:
            human_term = human_term + config.base.boundary_weight * boundary_aware_loss(
                pred, target, regions)
        # the reference skips the human term when the regions are empty: a
        # select, so neither a value nor a gradient of the term leaks through
        human = torch.where(regions.sum() > 0, human_term, torch.zeros_like(human_term))
    comps["human"] = human
    total = config.base_loss_weight * base_total + config.human_feedback_weight * human
    comps["total"] = total
    return total, comps
