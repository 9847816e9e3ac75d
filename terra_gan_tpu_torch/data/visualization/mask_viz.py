"""Multi-panel mask visualization (counterpart of
terra_gan_tpu/data/visualization/mask_viz.py; reference:
utils/mask_processing/visualization.py:8-55): the aerial RGB plus each
detector mask with a per-type colormap, saved as one figure for QA.
matplotlib is imported when a figure is drawn, not with the module."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

_CMAPS = {
    "roads": "Reds",
    "buildings": "Purples",
    "vegetation": "Greens",
    "fields": "YlOrBr",
    "combined": "gray",
}


def visualize_masks(
    masks: Dict, output_path: str | Path, rgb_image: Optional[np.ndarray] = None
) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    panels = []
    if rgb_image is not None:
        panels.append(("aerial", rgb_image[..., ::-1], None))  # BGR -> RGB
    for kind, mask in masks.items():
        name = getattr(kind, "value", str(kind))
        panels.append((name, mask, _CMAPS.get(name, "gray")))

    cols = min(3, len(panels))
    rows = -(-len(panels) // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 5 * rows))
    axes = np.atleast_1d(axes).ravel()
    for ax, (name, img, cmap) in zip(axes, panels):
        ax.imshow(img, cmap=cmap)
        ax.set_title(name)
        ax.axis("off")
    for ax in axes[len(panels):]:
        ax.axis("off")
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, bbox_inches="tight", dpi=100)
    plt.close(fig)
    return output_path
