"""OS Digimap zip -> processed tile ingestion (counterpart of terra_gan_tpu/data/ingest.py).

Contract (reference: utils/zip_handler.py:18-125, data_extraction.py:29-58):
  * extract only members whose path mentions getmapping-dsm-2000 /
    getmapping_rgb_25cm
  * pair each DSM .asc with its RGB .jpg by child-grid stem
    (stem before the first '_', lowercased)
  * per tile: DSM -> normalized 512 PNG at processed/<parent>/raw/
    <child>.png; detector masks from the RGB; the combined (inverted,
    255 = preserved) mask written at RGB resolution to
    <child>_mask_resized.png (the reference never downscales it here;
    the dataset resizes at load time); optional multi-panel
    visualization
  * register tile (x, y) parsed from ^[a-z]{2}(\\d{2})(\\d{2})$
  * cleanup the extraction dir afterwards (cleanup_extracted config)

Tiles are processed on a host thread pool of min(8, cores) threads, as
in the JAX package: PIL reads and writes the images there, and the
detectors run on ``device`` (the card unless the caller asks for the
CPU), one tile at a time (``MaskPipeline``).
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Tuple

from ..config import Config
from .asc import asc_to_png
from .mask_processing.pipeline import MaskPipeline, MaskType, read_bgr, write_gray
from .paths import PathManager
from .splitting import GeographicalSplitter

logger = logging.getLogger(__name__)

TARGET_FOLDERS = ("getmapping-dsm-2000", "getmapping_rgb_25cm")
_TILE_RE = re.compile(r"^[a-z]{2}(\d{2})(\d{2})$")


def extract_target_folders(
    zip_path: str | Path,
    extract_to: str | Path,
    targets: Tuple[str, ...] = TARGET_FOLDERS,
) -> bool:
    """Selective extraction of the DSM/RGB folders from a Digimap zip."""
    extract_to = Path(extract_to)
    try:
        with zipfile.ZipFile(zip_path) as zf:
            members = [
                m for m in zf.namelist()
                if any(t in m for t in targets)
            ]
            for m in members:
                zf.extract(m, extract_to)
        if not members:
            logger.warning("no target folders in %s", zip_path)
            return False
        return True
    except Exception as e:
        logger.error("extraction failed for %s: %s", zip_path, e)
        return False


def parse_tile_xy(child_name: str) -> Optional[Tuple[int, int]]:
    m = _TILE_RE.match(child_name.lower())
    if not m:
        return None
    return int(m.group(1)), int(m.group(2))


def ingest_zip(
    zip_path: str | Path,
    parent_grid: str,
    config: Config,
    mask_pipeline: Optional[MaskPipeline] = None,
    splitter: Optional[GeographicalSplitter] = None,
    max_workers: Optional[int] = None,
    device="cuda",
) -> bool:
    """Full zip -> tiles -> masks -> registered grid ingestion.

    max_workers defaults to min(8, host cores). Without ``mask_pipeline``
    the detectors run on ``device``.
    """
    if max_workers is None:
        max_workers = max(1, min(8, os.cpu_count() or 1))
    parent_grid = parent_grid.upper()
    pm = PathManager(config)
    paths = pm.create_parent_structure(parent_grid)
    extracted = Path(config.data.raw_dir) / f"{parent_grid}_extracted"

    if not extract_target_folders(zip_path, extracted):
        return False

    dsm_dir = next(extracted.glob("**/getmapping-dsm-2000*"), None)
    rgb_dir = next(extracted.glob("**/getmapping_rgb_25cm*"), None)
    if dsm_dir is None or rgb_dir is None:
        logger.error("%s: DSM/RGB directories not found", parent_grid)
        return False

    pipeline = mask_pipeline or MaskPipeline(config.mask_processing, device=device)
    grid = splitter or GeographicalSplitter(
        parent_grid, Path(config.data.processed_dir)
    )
    viz_enabled = bool(
        (config.mask_processing.get("visualization") or {}).get("enabled")
    )

    work = []
    for dsm_file in sorted(dsm_dir.glob("**/*.asc")):
        child = dsm_file.stem.split("_")[0].lower()
        rgb_file = next(rgb_dir.glob(f"**/{child}*.jpg"), None)
        if rgb_file is None:
            logger.warning("no RGB match for %s", child)
            continue
        work.append((dsm_file, rgb_file, child))

    def process_tile(item) -> Optional[Tuple[str, Path, Tuple[int, int]]]:
        dsm_file, rgb_file, child = item
        try:
            cp = pm.child_paths(parent_grid, child)
            if not asc_to_png(dsm_file, cp["raw"]):
                return None
            rgb = read_bgr(rgb_file)
            masks = pipeline.process_image(rgb)
            write_gray(cp["mask"], masks[MaskType.COMBINED])
            if viz_enabled:
                from .visualization.mask_viz import visualize_masks

                visualize_masks(
                    masks, paths["visualization"] / f"{child}_masks.png", rgb
                )
            xy = parse_tile_xy(child)
            if xy is None:
                logger.warning("cannot parse x,y from %s", child)
                return None
            return child, cp["raw"], xy
        except Exception as e:
            logger.error("tile %s failed: %s", child, e)
            return None

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        results = list(pool.map(process_tile, work))

    ok = 0
    for res in results:
        if res is None:
            continue
        child, raw_path, (x, y) = res
        grid.add_tile(raw_path, x, y)
        ok += 1
    logger.info(
        "%s: %d tiles processed, %d failed", parent_grid, ok, len(results) - ok
    )

    if config.raw.get("cleanup_extracted", True):
        shutil.rmtree(extracted, ignore_errors=True)
    return ok > 0
