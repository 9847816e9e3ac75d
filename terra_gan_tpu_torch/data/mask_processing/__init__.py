"""Inpainting masks from RGB aerial tiles: the four detectors and their combination, without OpenCV."""

from .detectors import BuildingDetector, FieldDetector, RoadDetector, VegetationDetector
from .pipeline import PRIORITY, MaskPipeline, MaskType, combine_masks, resize_mask_to_dem

__all__ = [
    "PRIORITY",
    "BuildingDetector",
    "FieldDetector",
    "MaskPipeline",
    "MaskType",
    "RoadDetector",
    "VegetationDetector",
    "combine_masks",
    "resize_mask_to_dem",
]
