"""Human-annotation matching and dataset validation (counterpart of
terra_gan_tpu/portal/helpers.py).

Contract (reference: utils/human_guided_helpers.py:15-139):
  * human annotations live in data/output/<grid>/human_annotation_masks;
    the tile id is the first '_'-separated filename token of 2 letters
    and >= 4 digits, lower-cased (NJ05_colored_nj0957_<user>_mask.png ->
    nj0957; a grid such as NJ05 has only 2 digits and is skipped)
  * system masks are <tile>_mask_resized.png in the grid's test/masks
  * a match also needs the test image <tile>.png; matches become the
    matched-pair dicts DirectMatchDataset reads
  * validate_dataset rejects a dataset whose human masks are all empty
    (and warns when some are)
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional

from ..config import Config

logger = logging.getLogger(__name__)


def extract_tile_token(filename_stem: str) -> Optional[str]:
    for part in filename_stem.split("_"):
        if len(part) >= 6 and part[:2].isalpha() and part[2:].isdigit():
            return part.lower()
    return None


def match_human_and_system_masks(grid_square: str, config: Optional[Config] = None) -> List[Dict]:
    cfg = config or Config()
    processed_dir = Path(cfg.data.processed_dir)
    human_dir = Path(cfg.data.output_dir) / grid_square / cfg.data.human_annotation_masks_dir
    system_dir = processed_dir / grid_square / "test" / "masks"
    image_dir = processed_dir / grid_square / "test" / "images"

    if not human_dir.exists():
        logger.error("human annotation dir missing: %s", human_dir)
        return []
    if not system_dir.exists():
        logger.error("system masks dir missing: %s", system_dir)
        return []

    systems = {p.stem.replace("_mask_resized", "").lower(): p
               for p in system_dir.glob("*_mask_resized.png")}
    humans: Dict[str, Path] = {}
    for p in human_dir.glob("*.png"):
        token = extract_tile_token(p.stem)
        if token:
            humans[token] = p

    matched = []
    for tile in sorted(set(systems) & set(humans)):
        image_path = image_dir / f"{tile}.png"
        if not image_path.exists():
            logger.warning("image missing for tile %s", tile)
            continue
        matched.append({"tile_name": tile, "image_path": image_path,
                        "system_mask_path": systems[tile], "human_mask_path": humans[tile]})
    logger.info("%d matched pairs (%d system, %d human)", len(matched), len(systems), len(humans))
    return matched


def fetch_annotations_for_grid(
    grid_square: str, portal_client, config: Optional[Config] = None
) -> Optional[Path]:
    """Download a grid's annotations into its human_annotation_masks dir."""
    cfg = config or Config()
    target = Path(cfg.data.output_dir) / grid_square / cfg.data.human_annotation_masks_dir
    target.mkdir(parents=True, exist_ok=True)
    paths = portal_client.fetch_annotations(grid_square, download_dir=target.parent)
    if paths:
        # the client downloads under <download_dir>/<grid>: move them in
        for p in paths:
            dest = target / p.name
            if p != dest:
                p.replace(dest)
        logger.info("downloaded %d annotations to %s", len(paths), target)
        return target
    logger.error("no annotations for %s", grid_square)
    return None


def validate_dataset(dataset) -> bool:
    """Reject a dataset whose human masks are all empty.

    As in the JAX package, only the first 10 items are probed; all items
    are counted only when those 10 are all empty, and the warning's count
    is then of the probe alone.
    """
    total = len(dataset)
    if total == 0:
        logger.error("dataset is empty")
        return False
    probe = min(10, total)
    empty = sum(1 for i in range(probe) if dataset[i]["human_mask"].sum() == 0)
    if empty == probe:
        empty = sum(1 for i in range(total) if dataset[i]["human_mask"].sum() == 0)
    else:
        total = probe
    if empty == total:
        logger.error("all human masks are empty; aborting")
        return False
    if empty:
        logger.warning("%d/%d human masks are empty", empty, total)
    return True
