"""Inference serving on the card: HTTP with dynamic micro-batching, and its client."""

from .client import InpaintClient, ServingError
from .server import InpaintService, MicroBatcher, make_server

__all__ = ["InpaintClient", "InpaintService", "MicroBatcher", "ServingError", "make_server"]
