"""Feature detectors over 25 cm RGB aerial tiles (counterpart of
terra_gan_tpu/data/mask_processing/detectors.py), without OpenCV.

The detected features become the holes the GAN fills. Each detector is
the JAX package's, step for step, with OpenCV's primitives replaced by
``cv_ops``: the pixel work runs as PyTorch ops on the detector's device,
the Hough walk and the contour fill on the host.

  * roads: CLAHE-enhanced gray -> bilateral filter -> Canny(lo, hi) ->
    remove HSV-green pixels -> probabilistic Hough (OpenCV's point order,
    from a ``CvRNG`` with OpenCV's seed) -> keep lines within 20 degrees
    of 0 or 90 -> draw at ``line_thickness`` -> 3x3 close;
  * buildings: a stub that returns an empty mask, as in the reference;
  * vegetation: HSV green range AND the min-max-normalised excess-green
    index above 127 -> close, open -> drop contours of area <= min_area;
  * fields: LAB L -> bilateral -> inverse adaptive Gaussian threshold ->
    remove vegetation -> close, open -> area filter.

Each detector takes a BGR uint8 image (a numpy array, or a tensor already
on its device) and returns a uint8 {0, 255} numpy mask, 255 = detected.
A detector that fails logs the error and returns an all-zero mask (the
reference's log-and-continue).
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional

import numpy as np
import torch

from ...utils.device import resolve_device
from . import cv_ops

logger = logging.getLogger(__name__)

_HSV_GREEN = ((35, 50, 50), (85, 255, 255))
_HSV_VEGETATION = ((30, 40, 40), (90, 255, 255))
# HoughLinesP seeds its generator with (uint64)-1 on every call
HOUGH_SEED = 0xFFFFFFFFFFFFFFFF


def _empty_like(image) -> np.ndarray:
    h, w = image.shape[:2]
    return np.zeros((h, w), np.uint8)


def _on(image, dev: torch.device) -> torch.Tensor:
    if isinstance(image, torch.Tensor):
        return image.to(dev)
    return torch.from_numpy(np.ascontiguousarray(image)).to(dev)


def _u8(mask) -> np.ndarray:
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    return mask.astype(np.uint8) * 255


def _green_mask(img: torch.Tensor) -> torch.Tensor:
    return cv_ops.in_range(cv_ops.bgr_to_hsv(img), *_HSV_GREEN)


class _Detector:
    def __init__(self, config: Optional[Dict] = None, device="cuda"):
        self.config = config or {}
        self.device = resolve_device(device)

    def detect(self, image) -> np.ndarray:
        try:
            return self._detect(_on(image, self.device))
        except Exception as e:  # log-and-continue, reference behavior
            logger.error("%s detection failed: %s", self.name, e)
            return _empty_like(image)


class RoadDetector(_Detector):
    name = "road"

    def __init__(self, config: Optional[Dict] = None, device="cuda"):
        super().__init__(config, device)
        cfg = self.config
        self.canny_low = cfg.get("canny_low", 150)
        self.canny_high = cfg.get("canny_high", 300)
        self.hough_threshold = cfg.get("hough_threshold", 100)
        self.hough_min_length = cfg.get("hough_min_length", 100)
        self.hough_max_gap = cfg.get("hough_max_gap", 20)
        self.line_thickness = cfg.get("line_thickness", 3)

    def _detect(self, img: torch.Tensor) -> np.ndarray:
        smooth = cv_ops.bilateral_filter(cv_ops.clahe(cv_ops.bgr_to_gray(img)), 9, 75, 75)
        edges = cv_ops.canny(smooth, self.canny_low, self.canny_high) & ~_green_mask(img)
        lines = cv_ops.hough_lines_p(
            edges, math.pi / 180, self.hough_threshold,
            self.hough_min_length, self.hough_max_gap, cv_ops.CvRNG(HOUGH_SEED),
        )
        drawn = np.zeros(edges.shape, bool)
        for x1, y1, x2, y2 in lines:
            angle = abs(np.degrees(np.arctan2(y2 - y1, x2 - x1)))
            if angle < 20 or abs(angle - 90) < 20 or abs(angle - 180) < 20:
                cv_ops.draw_thick_line(drawn, x1, y1, x2, y2, self.line_thickness)
        return _u8(cv_ops.morph_close(torch.from_numpy(drawn).to(img.device), 3))


class BuildingDetector(_Detector):
    """Stub by contract: the reference reserves this for a future
    segmentation model and always returns an empty mask."""

    name = "building"

    def detect(self, image) -> np.ndarray:
        return _empty_like(image)


class VegetationDetector(_Detector):
    name = "vegetation"

    def __init__(self, config: Optional[Dict] = None, device="cuda"):
        super().__init__(config, device)
        self.min_area = self.config.get("min_area", 5000)
        self.kernel_size = self.config.get("morph_kernel_size", 5)

    def _detect(self, img: torch.Tensor) -> np.ndarray:
        hue = cv_ops.in_range(cv_ops.bgr_to_hsv(img), *_HSV_VEGETATION)
        b, g, r = (img[..., c].to(torch.int32) for c in range(3))
        exg = cv_ops.minmax_normalize_u8(2 * g - r - b) > 127
        k = self.kernel_size
        opened = cv_ops.morph_open(cv_ops.morph_close(hue & exg, k), k)
        return _u8(cv_ops.keep_large_contours(opened, self.min_area))


class FieldDetector(_Detector):
    name = "field"

    def __init__(self, config: Optional[Dict] = None, device="cuda"):
        super().__init__(config, device)
        self.min_area = self.config.get("min_area", 10000)
        self.kernel_size = self.config.get("morph_kernel_size", 5)

    def _detect(self, img: torch.Tensor) -> np.ndarray:
        smoothed = cv_ops.bilateral_filter(cv_ops.bgr_to_lab_l(img), 9, 75, 75)
        binary = cv_ops.adaptive_threshold_gaussian_inv(smoothed, 25, 3) & ~_green_mask(img)
        k = self.kernel_size
        opened = cv_ops.morph_open(cv_ops.morph_close(binary, k), k)
        return _u8(cv_ops.keep_large_contours(opened, self.min_area))
