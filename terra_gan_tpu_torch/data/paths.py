"""Per-grid directory layout and grid references (counterpart of terra_gan_tpu/data/paths.py).

Contract (reference: utils/path_handling/path_utils.py:19-105):
  * parent grids: 2 letters + 2 digits (e.g. NJ05), from the zip's stem,
    uppercased
  * child grids: 2 letters + 4 digits (e.g. nj0957), any case
  * processed tree: metadata/ raw/ {train,val,test}/{images,masks}
  * output tree: inpainted/ colored/ visualization/ masks/
  * child path bundle: raw png, resized mask, inpainted, colored
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict

from ..config import Config

_PARENT_RE = re.compile(r"^[A-Za-z]{2}\d{2}$")
_CHILD_RE = re.compile(r"^[A-Za-z]{2}\d{4}$")


def is_valid_parent_grid(ref: str) -> bool:
    return bool(ref) and bool(_PARENT_RE.match(ref))


def is_valid_child_grid(ref: str) -> bool:
    return bool(ref) and bool(_CHILD_RE.match(ref))


class PathManager:
    """Owns the on-disk layout for every parent/child grid square."""

    def __init__(self, config: Config):
        self.config = config
        self.processed_root = Path(config.data.processed_dir)
        self.output_root = Path(config.data.output_dir)
        self.models_dir = Path(config.data.models_dir)

    def parent_from_zip(self, zip_path: str | Path) -> str:
        name = Path(zip_path).stem.upper()
        if not is_valid_parent_grid(name):
            raise ValueError(f"invalid parent grid square: {name}")
        return name

    def create_parent_structure(self, parent_grid: str) -> Dict[str, Path]:
        processed = self.processed_root / parent_grid
        for sub in self.config.data.processed_structure:
            (processed / sub).mkdir(parents=True, exist_ok=True)
        output = self.output_root / parent_grid
        for sub in self.config.data.output_structure:
            (output / sub).mkdir(parents=True, exist_ok=True)
        return {
            "processed": processed,
            "processed_raw": processed / "raw",
            "processed_metadata": processed / "metadata",
            "output": output,
            "output_inpainted": output / "inpainted",
            "output_colored": output / "colored",
            "visualization": output / "visualization",
            "masks": output / "masks",
        }

    def child_paths(self, parent_grid: str, child_name: str) -> Dict[str, Path]:
        if not is_valid_child_grid(child_name):
            raise ValueError(f"invalid child grid: {child_name}")
        base = self.create_parent_structure(parent_grid)
        return {
            "raw": base["processed_raw"] / f"{child_name}.png",
            "mask": base["processed_raw"] / f"{child_name}_mask_resized.png",
            "inpainted": base["output_inpainted"] / f"{child_name}_inpainted.png",
            "colored": base["output_colored"] / f"{child_name}_colored.png",
        }

    def split_dirs(self, parent_grid: str, split: str) -> Dict[str, Path]:
        processed = self.processed_root / parent_grid
        return {
            "images": processed / split / "images",
            "masks": processed / split / "masks",
        }
