"""Spatially-aware train/val/test tile splitting (counterpart of
terra_gan_tpu/data/splitting.py).

Contract (reference: utils/data_splitting.py:112-196): tiles are keyed
by (x, y) grid coordinates; the split is a cyclic Latin square indexed
by ((x - min_x) % 3, (y - min_y) % 3), an exact 1/3:1/3:1/3
distribution with no two 4-adjacent tiles in the same split, in the
closed form

    split = ("test", "val", "train")[(px + py) % 3]

Requested split_ratios are validated but do NOT change the pattern — a
documented reference quirk preserved here.

Metadata is written in the JAX package's format, so that either
package reads the other's: split_mapping.json ("x,y" -> split) and
coordinate_mapping.json (path -> {x, y, split, parent_grid})
(data_splitting.py:86-110).
"""

from __future__ import annotations

import json
import logging
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

from .paths import is_valid_child_grid

logger = logging.getLogger(__name__)

SPLIT_CYCLE = ("test", "val", "train")
SPLITS = ("train", "val", "test")


def checkerboard_split(x: int, y: int, min_x: int, min_y: int) -> str:
    """Closed form of the reference's 10x10 Latin-square pattern."""
    return SPLIT_CYCLE[((x - min_x) % 3 + (y - min_y) % 3) % 3]


@dataclass
class TileRecord:
    path: Path
    x: int
    y: int
    split: Optional[str] = None


class GeographicalSplitter:
    """Assigns tiles to splits and materializes per-split directories
    (the reference GeographicalDataHandler's add_tile / generate_splits /
    apply_splits / save_metadata / load_metadata / get_split_statistics)."""

    def __init__(self, parent_grid: str, root_dir: str | Path):
        self.parent_grid = parent_grid
        self.root_dir = Path(root_dir) / parent_grid
        self.tiles: Dict[Tuple[int, int], TileRecord] = {}
        self.assignments: Dict[Tuple[int, int], str] = {}

    def add_tile(self, tile_path: str | Path, x: int, y: int) -> None:
        tile_path = Path(tile_path)
        if not is_valid_child_grid(tile_path.stem.lower()):
            raise ValueError(f"invalid tile name: {tile_path.stem}")
        self.tiles[(x, y)] = TileRecord(path=tile_path, x=x, y=y)

    def generate_splits(
        self, split_ratios: Optional[Dict[str, float]] = None
    ) -> None:
        ratios = split_ratios or {"train": 0.8, "val": 0.1, "test": 0.1}
        if abs(sum(ratios.values()) - 1.0) >= 1e-3:
            raise ValueError("split ratios must sum to 1.0")
        if not self.tiles:
            raise ValueError("no tiles registered")
        min_x = min(x for x, _ in self.tiles)
        min_y = min(y for _, y in self.tiles)
        for (x, y), rec in self.tiles.items():
            split = checkerboard_split(x, y, min_x, min_y)
            self.assignments[(x, y)] = split
            rec.split = split
        self._warn_adjacency()

    def _warn_adjacency(self) -> None:
        for (x, y), split in self.assignments.items():
            for nx, ny in ((x + 1, y), (x - 1, y), (x, y + 1), (x, y - 1)):
                if self.assignments.get((nx, ny)) == split:
                    logger.warning(
                        "adjacent tiles (%d,%d)/(%d,%d) share split %s",
                        x, y, nx, ny, split,
                    )

    def apply_splits(self) -> None:
        """Copy DEM + mask pairs into {split}/{images,masks} dirs."""
        dirs = {}
        for split in SPLITS:
            for kind in ("images", "masks"):
                d = self.root_dir / split / kind
                d.mkdir(parents=True, exist_ok=True)
                dirs[(split, kind)] = d
        for coord, rec in self.tiles.items():
            split = self.assignments.get(coord)
            if split is None:
                continue
            mask_path = rec.path.parent / f"{rec.path.stem}_mask_resized.png"
            if rec.path.exists():
                shutil.copy2(rec.path, dirs[(split, "images")] / rec.path.name)
            if mask_path.exists():
                shutil.copy2(mask_path, dirs[(split, "masks")] / mask_path.name)

    def save_metadata(self) -> None:
        meta = self.root_dir / "metadata"
        meta.mkdir(parents=True, exist_ok=True)
        with open(meta / "split_mapping.json", "w") as f:
            json.dump(
                {f"{x},{y}": s for (x, y), s in self.assignments.items()},
                f, indent=2,
            )
        with open(meta / "coordinate_mapping.json", "w") as f:
            json.dump(
                {
                    str(rec.path): {
                        "x": rec.x,
                        "y": rec.y,
                        "split": rec.split,
                        "parent_grid": self.parent_grid,
                    }
                    for rec in self.tiles.values()
                },
                f, indent=2,
            )

    def load_metadata(self) -> None:
        meta = self.root_dir / "metadata"
        try:
            with open(meta / "split_mapping.json") as f:
                self.assignments = {
                    tuple(map(int, k.split(","))): v
                    for k, v in json.load(f).items()
                }
        except FileNotFoundError:
            logger.warning("split_mapping.json not found in %s", meta)
        try:
            with open(meta / "coordinate_mapping.json") as f:
                for path_str, info in json.load(f).items():
                    self.tiles[(info["x"], info["y"])] = TileRecord(
                        path=Path(path_str),
                        x=info["x"],
                        y=info["y"],
                        split=info.get("split"),
                    )
        except FileNotFoundError:
            logger.warning("coordinate_mapping.json not found in %s", meta)

    def get_split_statistics(self) -> Dict[str, int]:
        stats = {s: 0 for s in SPLITS}
        for split in self.assignments.values():
            stats[split] += 1
        return stats


# the reference's class name
GeographicalDataHandler = GeographicalSplitter
