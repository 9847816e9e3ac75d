"""Visualization: the DSM colorizer, mask panels and split maps (matplotlib
is imported by the two figure functions, not here)."""

from .colorizer import DSMColorizer, build_lut
from .mask_viz import visualize_masks
from .split_viz import SplitVisualizer, create_split_visualization

__all__ = [
    "DSMColorizer",
    "SplitVisualizer",
    "build_lut",
    "create_split_visualization",
    "visualize_masks",
]
