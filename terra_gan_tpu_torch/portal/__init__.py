"""The human-in-the-loop portal layer (counterpart of terra_gan_tpu/portal):
its client, annotation matching, upload and PythonAnywhere tools on the
standard library's urllib, the WSGI portal server, and the HS256 bearer
tokens shared with the serving path."""

from .client import PortalClient, experiment_mode
from .helpers import (
    extract_tile_token,
    fetch_annotations_for_grid,
    match_human_and_system_masks,
    validate_dataset,
)
from .pythonanywhere import PythonAnywhereClient
from .upload_results import upload_results

__all__ = [
    "PortalClient",
    "PythonAnywhereClient",
    "experiment_mode",
    "extract_tile_token",
    "fetch_annotations_for_grid",
    "match_human_and_system_masks",
    "upload_results",
    "validate_dataset",
]


def create_server_app(*args, **kwargs):
    """The portal's WSGI app (``server.create_app``), imported on first use."""
    from .server import create_app

    return create_app(*args, **kwargs)
