"""Human-annotation validation and normalisation (counterpart of
terra_gan_tpu/data/annotation_validator.py; PIL and numpy only).

Contract (reference: utils/mask_processing/annotation_validator.py:13-230):
  * pairs human annotations (token after the first '_' in the stem,
    e.g. "colored_nj0957_...png" -> nj0957) with system masks
    (<child>_mask_resized.png)
  * size gate: exactly target (512x512) or within ±10%; 'strict' mode
    skips invalid pairs, 'resize' mode force-resizes everything
    (human bilinear, system NEAREST)
  * masks are binarized to {0,255} at >127 after any resize
  * valid pairs are written renumbered as images/NNNN.png +
    masks/NNNN.png with a validation_metadata.json carrying counters,
    size mismatches, and the index -> original-file mapping
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

logger = logging.getLogger(__name__)


def _binarize_if_needed(arr: np.ndarray) -> Tuple[np.ndarray, bool]:
    if np.isin(arr, (0, 255)).all():
        return arr, False
    return (arr > 127).astype(np.uint8) * 255, True


class AnnotationValidator:
    def __init__(
        self,
        target_size: Tuple[int, int] = (512, 512),
        max_size_difference_percent: float = 10,
        resize_mode: str = "strict",
    ):
        if resize_mode not in ("strict", "resize"):
            raise ValueError(f"unknown resize_mode: {resize_mode}")
        self.target_size = target_size
        self.max_diff = max_size_difference_percent / 100.0
        self.resize_mode = resize_mode

    def check_image_size(self, path) -> Tuple[bool, Optional[Tuple[int, int]]]:
        try:
            with Image.open(path) as img:
                width, height = img.size
        except Exception as e:
            logger.error("cannot read %s: %s", path, e)
            return False, None
        th, tw = self.target_size
        if (height, width) == (th, tw):
            return True, (height, width)
        ok = (
            abs(height - th) / th <= self.max_diff
            and abs(width - tw) / tw <= self.max_diff
        )
        return ok, (height, width)

    def _write_pair(
        self,
        human_path: Path,
        system_path: Path,
        img_out: Path,
        mask_out: Path,
        resize: bool,
        stats: Dict,
    ) -> bool:
        try:
            human = Image.open(human_path).convert("L")
            if resize:
                human = human.resize(self.target_size[::-1], Image.BILINEAR)
            arr, fixed = _binarize_if_needed(np.asarray(human))
            if fixed:
                stats["non_binary_human"] += 1
            Image.fromarray(arr).save(img_out)

            system = Image.open(system_path).convert("L")
            if resize:
                system = system.resize(self.target_size[::-1], Image.NEAREST)
            arr, fixed = _binarize_if_needed(np.asarray(system))
            if fixed:
                stats["non_binary_system"] += 1
            Image.fromarray(arr).save(mask_out)
            return True
        except Exception as e:
            logger.error("failed writing pair %s: %s", human_path, e)
            return False

    def validate_and_filter_pairs(
        self,
        human_masks: Sequence[Path],
        system_masks: Sequence[Path],
        output_dir: str | Path,
    ) -> Dict:
        output_dir = Path(output_dir)
        img_dir = output_dir / "images"
        mask_dir = output_dir / "masks"
        img_dir.mkdir(parents=True, exist_ok=True)
        mask_dir.mkdir(parents=True, exist_ok=True)

        stats: Dict = {
            "total_pairs": 0,
            "valid_pairs": 0,
            "invalid_human": 0,
            "invalid_system": 0,
            "resized_pairs": 0,
            "skipped_pairs": 0,
            "size_mismatches": [],
            "non_binary_human": 0,
            "non_binary_system": 0,
            "file_mapping": {},
        }

        humans: Dict[str, Path] = {}
        for f in human_masks:
            parts = Path(f).stem.split("_")
            if len(parts) >= 2:
                humans[parts[1]] = Path(f)
        systems = {
            Path(f).stem.replace("_mask_resized", ""): Path(f)
            for f in system_masks
        }
        logger.info(
            "%d human annotations, %d system masks", len(humans), len(systems)
        )

        count = 0
        for base, human_path in humans.items():
            system_path = systems.get(base)
            if system_path is None:
                continue
            stats["total_pairs"] += 1
            h_ok, h_size = self.check_image_size(human_path)
            s_ok, s_size = self.check_image_size(system_path)
            if not h_ok or not s_ok:
                stats["size_mismatches"].append(
                    {
                        "base_name": base,
                        "human_size": h_size,
                        "system_size": s_size,
                        "target_size": self.target_size,
                    }
                )
            if not h_ok:
                stats["invalid_human"] += 1
            if not s_ok:
                stats["invalid_system"] += 1

            if self.resize_mode == "strict" and not (h_ok and s_ok):
                stats["skipped_pairs"] += 1
                continue

            resize = self.resize_mode == "resize"
            ok = self._write_pair(
                human_path,
                system_path,
                img_dir / f"{count:04d}.png",
                mask_dir / f"{count:04d}.png",
                resize,
                stats,
            )
            if not ok:
                continue
            stats["file_mapping"][str(count)] = str(human_path)
            if resize:
                stats["resized_pairs"] += 1
            count += 1
            stats["valid_pairs"] += 1

        with open(output_dir / "validation_metadata.json", "w") as f:
            json.dump(stats, f, indent=2)
        logger.info(
            "annotation validation: %d/%d pairs valid",
            stats["valid_pairs"], stats["total_pairs"],
        )
        return stats


def validate_annotations(
    human_annotations_dir,
    system_masks_dir,
    output_dir,
    target_size: Tuple[int, int] = (512, 512),
    resize_mode: str = "resize",
) -> int:
    validator = AnnotationValidator(
        target_size=target_size, resize_mode=resize_mode
    )
    stats = validator.validate_and_filter_pairs(
        human_masks=list(Path(human_annotations_dir).glob("*.png")),
        system_masks=list(Path(system_masks_dir).glob("*_mask_resized.png")),
        output_dir=output_dir,
    )
    return stats["valid_pairs"]
