"""Mask generation: detectors -> combined inpainting mask (counterpart of
terra_gan_tpu/data/mask_processing/pipeline.py), without OpenCV.

Combination contract (reference: utils/mask_processing/core.py:77-171):
  * run all four detectors, binarize each at > 127, OR them in priority
    order buildings > roads > vegetation > fields;
  * INVERT the result: 0 = detected feature (a hole to inpaint), 255 =
    preserved background, which is what the dataset consumes;
  * a mask of another size is nearest-resized (cv2.INTER_NEAREST) first.

resize_mask_to_dem (core.py:191-226): nearest-resize the combined mask
to the DEM PNG's size, binarize at > 127 after resizing, save as
``<dem_stem>_mask_resized.png``.

Images are read with PIL and handed to the detectors as BGR, as
``cv2.imread`` gives them. The detectors' pixel work runs on the
pipeline's device, one image at a time: each detector meets the host
many times (the Hough search once a chunk, the hysteresis, the contour
labelling), and threads that share the interpreter lock stall at each
of those syncs, so that on an H100 eight threads ingested 16 2000^2
tiles in 36 s where one took 17. Concurrent callers (``process_batch``,
the ingest's pool) overlap their reads and writes with it.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from enum import Enum
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...utils.device import resolve_device
from .cv_ops import resize_nearest
from .detectors import BuildingDetector, FieldDetector, RoadDetector, VegetationDetector

logger = logging.getLogger(__name__)


class MaskType(Enum):
    ROADS = "roads"
    BUILDINGS = "buildings"
    VEGETATION = "vegetation"
    FIELDS = "fields"
    COMBINED = "combined"


# priority order for the bitwise-OR combination (core.py:108-113)
PRIORITY = (
    MaskType.BUILDINGS,
    MaskType.ROADS,
    MaskType.VEGETATION,
    MaskType.FIELDS,
)


def read_bgr(path: str | Path) -> np.ndarray:
    """An image file as a BGR uint8 array, as cv2.imread(path) returns it."""
    from PIL import Image

    with Image.open(path) as img:
        return np.ascontiguousarray(np.asarray(img.convert("RGB"))[..., ::-1])


def read_gray(path: str | Path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("L"))


def write_gray(path: str | Path, mask: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(mask, np.uint8), mode="L").save(path)


def combine_masks(
    masks: Dict[MaskType, np.ndarray], invert_output: bool = True
) -> np.ndarray:
    """OR-combine binarized detector masks; invert so 255 = preserved."""
    ref = next(iter(masks.values()))
    h, w = ref.shape[:2]
    combined = np.zeros((h, w), np.uint8)
    for mask_type in PRIORITY:
        mask = masks.get(mask_type)
        if mask is None:
            continue
        if mask.shape[:2] != (h, w):
            mask = resize_nearest(mask, w, h)
        combined |= np.where(mask > 127, np.uint8(255), np.uint8(0))
    return (255 - combined) if invert_output else combined


def resize_mask_to_dem(
    mask: np.ndarray | str | Path,
    dem_png_path: str | Path,
    output_path: Optional[str | Path] = None,
) -> Path:
    """Nearest-resize mask to DEM dims, binarize >127, save *_mask_resized.png."""
    arr = read_gray(mask) if isinstance(mask, (str, Path)) else mask
    dem = read_gray(dem_png_path)
    h, w = dem.shape[:2]
    resized = np.where(resize_nearest(arr, w, h) > 127, np.uint8(255), np.uint8(0))
    dem_png_path = Path(dem_png_path)
    out = (
        Path(output_path)
        if output_path
        else dem_png_path.parent / f"{dem_png_path.stem}_mask_resized.png"
    )
    write_gray(out, resized)
    return out


class MaskPipeline:
    """Runs the four detectors on ``device`` and combines their outputs."""

    def __init__(self, config: Optional[Dict] = None, max_workers: int = 8, device="cuda"):
        cfg = config or {}
        self.device = resolve_device(device)
        self.detectors = {
            MaskType.ROADS: RoadDetector(cfg.get("roads") or {}, self.device),
            MaskType.BUILDINGS: BuildingDetector(cfg.get("buildings") or {}, self.device),
            MaskType.VEGETATION: VegetationDetector(cfg.get("vegetation") or {}, self.device),
            MaskType.FIELDS: FieldDetector(cfg.get("fields") or {}, self.device),
        }
        self.max_workers = max_workers
        self._device_lock = threading.Lock()

    def process_image(
        self, image: np.ndarray | str | Path
    ) -> Dict[MaskType, np.ndarray]:
        """All masks for one BGR aerial image (array or path)."""
        arr = read_bgr(image) if isinstance(image, (str, Path)) else image
        with self._device_lock:
            img = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
            masks = {kind: det.detect(img) for kind, det in self.detectors.items()}
        masks[MaskType.COMBINED] = combine_masks(masks)
        return masks

    def process_batch(
        self, image_paths: Sequence[str | Path]
    ) -> List[Optional[Dict[MaskType, np.ndarray]]]:
        """Thread-parallel mask generation across many tiles."""
        def one(p):
            try:
                return self.process_image(p)
            except Exception as e:
                logger.error("mask generation failed for %s: %s", p, e)
                return None

        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            return list(pool.map(one, image_paths))
