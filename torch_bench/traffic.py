"""The benchmark's one traffic generator: tiles, masks and arrival schedules
from a seed and a mix's parameters (``torch_bench/traffic/<mix>.json``).

Tiles are DSM-like relief: a sum of six plane waves, eight flat-topped
blocks (the structures), scaled to the full grey range and truncated to
uint8. Masks are 0/255 with four rectangular holes (0 = cut out). Sizes
of blocks and holes are fractions of the tile side, so a small tile in
a CPU test has the same shapes. The draws are made on the device in one
batch, so set-up stays short.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def _generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 16 + stream) % 2**63)
    return gen


def _rects(n: int, count: int, side: int, lo: float, hi: float, gen, device):
    """[n, count] rectangles: (y0, x0, h, w), sides in [lo, hi) * side, inside the tile."""
    u = torch.rand(n, count, 4, generator=gen, device=device)
    lo_px, hi_px = max(1, round(lo * side)), max(2, round(hi * side))
    hw = (lo_px + u[..., 2:] * (hi_px - lo_px)).floor()
    origin = (u[..., :2] * (side - hi_px)).floor()
    return torch.cat([origin, hw], -1)


def _inside(rects: torch.Tensor, side: int, device) -> torch.Tensor:
    """[n, count, side, side] bool: the pixels each rectangle covers."""
    ax = torch.arange(side, device=device, dtype=torch.float32)
    y0, x0, h, w = (rects[..., i, None] for i in range(4))
    rows = (ax >= y0) & (ax < y0 + h)
    cols = (ax >= x0) & (ax < x0 + w)
    return rows[..., :, None] & cols[..., None, :]


def dsm_tiles(n: int, side: int, seed: int, device: torch.device,
              stream: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(images, masks): uint8 [n, side, side, 1] each, on the host."""
    gen = _generator(seed, stream, device)
    ax = torch.arange(side, device=device, dtype=torch.float32) / side
    yy, xx = ax[:, None], ax[None, :]
    waves = torch.rand(n, 6, 4, generator=gen, device=device)
    z = torch.zeros(n, side, side, device=device)
    for k in range(6):
        fy, fx = (0.5 + 3.5 * waves[:, k, i, None, None] for i in (0, 1))
        phase = 6.3 * waves[:, k, 2, None, None]
        amp = 0.2 + 0.8 * waves[:, k, 3, None, None]
        z += amp * torch.sin(2 * math.pi * (fy * yy + fx * xx) + phase)
    blocks = _rects(n, 8, side, 1 / 64, 5 / 64, gen, device)
    heights = 0.5 + torch.rand(n, 8, generator=gen, device=device)
    for k in range(8):
        z += _inside(blocks[:, k : k + 1], side, device)[:, 0] * heights[:, k, None, None]
    lo = z.amin((1, 2), keepdim=True)
    z = (z - lo) / (z.amax((1, 2), keepdim=True) - lo)
    images = (z * 255).to(torch.uint8)
    holes = _inside(_rects(n, 4, side, 1 / 32, 3 / 16, gen, device), side, device).any(1)
    masks = torch.where(holes, 0, 255).to(torch.uint8)
    return images[..., None].cpu().numpy(), masks[..., None].cpu().numpy()


def human_masks(n: int, side: int, seed: int, device: torch.device,
                count: int = 2) -> np.ndarray:
    """uint8 [n, side, side, 1] 0/255 masks of an annotator's regions."""
    gen = _generator(seed, 1, device)
    regions = _inside(_rects(n, count, side, 1 / 16, 1 / 4, gen, device), side, device).any(1)
    return (regions.to(torch.uint8) * 255)[..., None].cpu().numpy()


def tile_set(mix: dict, n: int, side: int, seed: int, device: torch.device,
             human: bool = False):
    """The mix's tiles: one fixed set (``tile_set_seed``), the same for every
    run seed, in an order drawn from the run seed, so a seed changes the
    order, not the work. (images, masks[, human masks]), uint8 on the host."""
    images, masks = dsm_tiles(n, side, mix["tile_set_seed"], device)
    out = [images, masks] + ([human_masks(n, side, mix["tile_set_seed"], device)] if human else [])
    order = np.random.default_rng([seed % 2**63, 4]).permutation(n)
    return tuple(a[order] for a in out)


def poisson_schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Send times (s from the window's start) of an open-loop Poisson stream:
    round(rate * seconds) arrivals whose gaps are one fixed sequence of
    exponential draws, scaled to fill the window, started at a point drawn
    from the seed (a rotation). Every seed sends the same requests with
    the same bursts, so a seed moves where the window cuts the stream,
    not the work."""
    n = max(1, round(rate * seconds))
    gaps = np.random.default_rng(0x7A11).exponential(1.0, n + 1)
    gaps *= seconds / gaps.sum()
    shift = int(np.random.default_rng([seed % 2**63, 2]).integers(n + 1))
    return np.cumsum(np.roll(gaps, shift))[:-1]
