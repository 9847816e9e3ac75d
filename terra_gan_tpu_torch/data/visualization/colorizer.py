"""DSM colorizer: grayscale elevation -> terrain palette PNG (counterpart of
terra_gan_tpu/data/visualization/colorizer.py).

Contract (reference: utils/visualization/dsm_colorizer.py:14-51): an
8-stop green->white topographic gradient applied to the grayscale tile
through a 256-entry LUT; every ``*_inpainted.png`` becomes
``<stem>_colored.png``. These colored tiles are what human annotators
review in the portal. PIL reads and writes the PNGs where the JAX
package uses OpenCV, which the card's machine lacks: the pixels are the
same (a grayscale PNG decodes to the same bytes, and the RGB PNG is
lossless either way).
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

# terrain stops, low -> high elevation (hex RGB)
TERRAIN_STOPS = (
    "#0C6B58",  # deep green
    "#2E8B57",  # sea green
    "#90EE90",  # light green
    "#F4D03F",  # yellow
    "#E67E22",  # orange
    "#CB4335",  # red
    "#6E2C00",  # brown
    "#FFFFFF",  # white peaks
)


def _hex_to_rgb(h: str) -> np.ndarray:
    h = h.lstrip("#")
    return np.array([int(h[i : i + 2], 16) for i in (0, 2, 4)], np.float64)


def build_lut(stops=TERRAIN_STOPS, size: int = 256) -> np.ndarray:
    """[size, 3] uint8 RGB lookup table, linear between stops."""
    pts = np.stack([_hex_to_rgb(s) for s in stops])  # [S, 3]
    x = np.linspace(0.0, 1.0, size)
    xp = np.linspace(0.0, 1.0, len(stops))
    lut = np.stack(
        [np.interp(x, xp, pts[:, c]) for c in range(3)], axis=1
    )
    return np.clip(np.rint(lut), 0, 255).astype(np.uint8)


class DSMColorizer:
    """Recolors inpainted DSM tiles for the annotation portal."""

    def __init__(self, input_dir: str | Path, output_dir: str | Path):
        self.input_dir = Path(input_dir)
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self._lut = build_lut()

    def colorize_array(self, gray: np.ndarray) -> np.ndarray:
        """uint8 grayscale [H,W] -> RGB uint8 [H,W,3]."""
        return self._lut[gray]

    def recolor_dsm(self, img_path: str | Path) -> Path:
        from PIL import Image

        img_path = Path(img_path)
        try:
            with Image.open(img_path) as img:
                gray = np.asarray(img.convert("L"))
        except OSError as e:  # PIL's UnidentifiedImageError included
            raise ValueError(f"cannot read {img_path}") from e
        out = self.output_dir / f"{img_path.stem}_colored.png"
        Image.fromarray(self.colorize_array(gray)).save(out)  # [H,W,3] uint8: RGB
        return out

    def recolor_all(self) -> List[Path]:
        return [
            self.recolor_dsm(p)
            for p in sorted(self.input_dir.glob("*_inpainted.png"))
        ]
