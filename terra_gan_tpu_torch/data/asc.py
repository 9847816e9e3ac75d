"""ESRI ASCII grid (.asc) DSM ingestion (counterpart of terra_gan_tpu/data/asc.py).

Behavior contract (reference: utils/data_extraction.py:60-115):
  * 6-line header (ncols nrows xllcorner yllcorner cellsize NODATA_value)
  * NODATA cells -> treated as missing, rendered 0 after normalization
  * per-tile min-max normalization to 0..255 uint8 (this discards
    absolute elevation, so cross-tile seams exist by design)
  * flat tiles (min == max) -> all zeros
  * quantize to uint8 FIRST, then bilinear-resize the uint8 image to
    512x512 (PIL semantics) — order matters for bit-parity.

The body is parsed in one vectorized numpy pass; the JAX package's
native parser is not ported.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image

HEADER_KEYS = (
    "ncols", "nrows", "xllcorner", "yllcorner", "cellsize", "NODATA_value"
)
DEFAULT_NODATA = -9999.0
TARGET_SIZE = 512


def read_asc(path: str | Path) -> Tuple[np.ndarray, Dict[str, float]]:
    """Parse an .asc file. Returns (data [nrows, ncols] float64 with NaN
    for NODATA, header dict)."""
    header: Dict[str, float] = {}
    with open(path, "r") as f:
        for _ in range(6):
            parts = f.readline().split()
            if len(parts) != 2:
                raise ValueError(f"malformed .asc header in {path}")
            key, value = parts
            header[key] = float(value)
        body = f.read()
    nrows = int(header.get("nrows", 0))
    ncols = int(header.get("ncols", 0))
    nodata = header.get("NODATA_value", DEFAULT_NODATA)
    values = np.array(body.split(), dtype=np.float64)
    if nrows * ncols != values.size:
        raise ValueError(f"{path}: expected {nrows * ncols} values, got {values.size}")
    grid = values.reshape(nrows, ncols)
    grid[grid == nodata] = np.nan
    return grid, header


def normalize_tile(data: np.ndarray) -> Optional[np.ndarray]:
    """Per-tile min-max normalize to uint8; NaN -> 0. None if all-NODATA."""
    if np.all(np.isnan(data)):
        return None
    lo, hi = np.nanmin(data), np.nanmax(data)
    if lo == hi:
        out = np.zeros_like(data)
    else:
        out = 255.0 * (data - lo) / (hi - lo)
    return np.nan_to_num(out, nan=0.0).astype(np.uint8)


def asc_to_png(
    asc_path: str | Path,
    png_path: str | Path,
    target_size: int = TARGET_SIZE,
) -> bool:
    """Convert one DSM .asc to a normalized grayscale PNG (512x512).

    Returns False (no file written) for all-NODATA tiles, mirroring the
    reference's log-and-skip behavior.
    """
    asc_path, png_path = Path(asc_path), Path(png_path)
    grid, _ = read_asc(asc_path)
    norm = normalize_tile(grid)
    if norm is None:
        return False
    png_path.parent.mkdir(parents=True, exist_ok=True)
    img = Image.fromarray(norm, mode="L")
    if target_size:
        img = img.resize((target_size, target_size), Image.BILINEAR)
    img.save(png_path)
    return True


def write_asc(
    path: str | Path,
    data: np.ndarray,
    xllcorner: float = 0.0,
    yllcorner: float = 0.0,
    cellsize: float = 2.0,
    nodata: float = DEFAULT_NODATA,
) -> None:
    """Write an ESRI ASCII grid (test fixtures / synthetic tiles)."""
    data = np.asarray(data, np.float64)
    out = np.where(np.isnan(data), nodata, data)
    with open(path, "w") as f:
        f.write(f"ncols {data.shape[1]}\n")
        f.write(f"nrows {data.shape[0]}\n")
        f.write(f"xllcorner {xllcorner}\n")
        f.write(f"yllcorner {yllcorner}\n")
        f.write(f"cellsize {cellsize}\n")
        f.write(f"NODATA_value {nodata}\n")
        np.savetxt(f, out, fmt="%.3f")
