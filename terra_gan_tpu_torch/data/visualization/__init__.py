"""Visualization: the DSM colorizer."""

from .colorizer import DSMColorizer, build_lut

__all__ = ["DSMColorizer", "build_lut"]
