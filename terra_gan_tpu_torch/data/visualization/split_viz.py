"""Split-assignment grid renderer (counterpart of
terra_gan_tpu/data/visualization/split_viz.py; reference:
utils/visualization/split_visualizer.py:38-104): the parent grid as a
colored tile map (train/val/test) from split_mapping.json, for QA of the
checkerboard pattern. matplotlib is imported when a figure is drawn."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

SPLIT_COLORS = {"train": "#4C72B0", "val": "#DD8452", "test": "#55A868"}


def load_split_mapping(metadata_dir: str | Path) -> Dict[Tuple[int, int], str]:
    with open(Path(metadata_dir) / "split_mapping.json") as f:
        return {
            tuple(map(int, k.split(","))): v for k, v in json.load(f).items()
        }


def create_split_visualization(
    metadata_dir: str | Path,
    output_path: Optional[str | Path] = None,
    parent_grid: str = "",
) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Patch, Rectangle

    mapping = load_split_mapping(metadata_dir)
    output_path = Path(
        output_path or Path(metadata_dir) / "split_visualization.png"
    )

    xs = [x for x, _ in mapping]
    ys = [y for _, y in mapping]
    fig, ax = plt.subplots(figsize=(8, 8))
    for (x, y), split in mapping.items():
        ax.add_patch(
            Rectangle(
                (x, y), 1, 1,
                facecolor=SPLIT_COLORS.get(split, "#888888"),
                edgecolor="white",
            )
        )
        ax.text(
            x + 0.5, y + 0.5, split[:2], ha="center", va="center",
            fontsize=8, color="white",
        )
    ax.set_xlim(min(xs), max(xs) + 1)
    ax.set_ylim(min(ys), max(ys) + 1)
    ax.set_aspect("equal")
    ax.set_title(f"Split assignment {parent_grid}".strip())
    ax.legend(
        handles=[
            Patch(facecolor=c, label=s) for s, c in SPLIT_COLORS.items()
        ],
        loc="upper right",
    )
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, bbox_inches="tight", dpi=100)
    plt.close(fig)
    return output_path


class SplitVisualizer:
    def __init__(self, metadata_dir: str | Path):
        self.metadata_dir = Path(metadata_dir)

    def render(self, output_path: Optional[str | Path] = None) -> Path:
        return create_split_visualization(self.metadata_dir, output_path)
