"""The OpenCV operations the mask detectors use, as PyTorch ops (no cv2).

Each function reproduces one OpenCV 8-bit primitive the JAX package's
detectors call (terra_gan_tpu/data/mask_processing/detectors.py), with
OpenCV's own fixed-point tables, border rules and rounding, so that the
port's masks match the reference's pixel for pixel where the operation
is exact and within a stated tolerance where OpenCV's float sums are
taken in another order (tests/test_torch_detectors.py holds each one to
cv2). Images are uint8 tensors on the caller's device: BGR ``[H, W, 3]``
or one channel ``[H, W]``; masks are bool ``[H, W]``.

The pixel work (colour conversions, inRange, CLAHE, the bilateral
filter, Canny's Sobel, non-maximum suppression and hysteresis,
morphology, the Gaussian adaptive threshold and the min-max normalise)
runs on the tensors' device. The sequential parts run on the host in
numpy and scipy: the probabilistic Hough transform's point walk, the
thick-line raster and the external-contour fill.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------
# colour conversions (OpenCV's 8-bit fixed-point paths)
# --------------------------------------------------------------------------

# COLOR_BGR2GRAY: 15-bit weights of B, G and R, rounded
_GRAY_B, _GRAY_G, _GRAY_R, _GRAY_SHIFT = 3735, 19235, 9798, 15

# COLOR_BGR2HSV, H in 0..180: reciprocal tables at a 12-bit shift
_HSV_SHIFT = 12
_SDIV = [0] + [round((255 << _HSV_SHIFT) / i) for i in range(1, 256)]
_HDIV180 = [0] + [round((180 << _HSV_SHIFT) / (6.0 * i)) for i in range(1, 256)]

# COLOR_BGR2LAB's L: an sRGB gamma table at 3 fractional bits, the Y row of
# the sRGB->XYZ(D65) matrix at 12 bits, and a cube-root table at 15 bits
_LAB_SHIFT, _GAMMA_SHIFT = 12, 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_LAB_Y = tuple(round((1 << _LAB_SHIFT) * c) for c in (0.212671, 0.715160, 0.072169))  # R, G, B
_L_SCALE = (116 * 255 + 50) // 100
_L_SHIFT = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)


def _srgb_gamma(x: float) -> float:
    return x / 12.92 if x <= 0.04045 else ((x + 0.055) / 1.055) ** 2.4


def _lab_cbrt(x: float) -> float:
    return x * 7.787 + 0.13793103448275862 if x < 0.008856 else x ** (1.0 / 3.0)


_GAMMA_TAB = [round(255.0 * (1 << _GAMMA_SHIFT) * _srgb_gamma(i / 255.0)) for i in range(256)]
_CBRT_TAB = [
    round((1 << _LAB_SHIFT2) * _lab_cbrt(i / (255.0 * (1 << _GAMMA_SHIFT))))
    for i in range(256 * 3 // 2 * (1 << _GAMMA_SHIFT))
]


def _table(values, dev) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=dev)


def _channels(bgr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    x = bgr.to(torch.int32)
    return x[..., 0], x[..., 1], x[..., 2]


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(img, COLOR_BGR2GRAY) on uint8."""
    b, g, r = _channels(bgr)
    y = b * _GRAY_B + g * _GRAY_G + r * _GRAY_R + (1 << (_GRAY_SHIFT - 1))
    return (y >> _GRAY_SHIFT).to(torch.uint8)


def bgr_to_hsv(bgr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """cv2.cvtColor(img, COLOR_BGR2HSV) on uint8: (H in 0..180, S, V) as int32."""
    b, g, r = _channels(bgr)
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _table(_SDIV, bgr.device)[v] + half) >> _HSV_SHIFT
    h = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _table(_HDIV180, bgr.device)[diff] + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return h, s, v


def bgr_to_lab_l(bgr: torch.Tensor) -> torch.Tensor:
    """The L channel of cv2.cvtColor(img, COLOR_BGR2LAB) on uint8 (L scaled to 0..255)."""
    b, g, r = _channels(bgr)
    gamma = _table(_GAMMA_TAB, bgr.device)
    cr, cg, cb = _LAB_Y
    y = gamma[r] * cr + gamma[g] * cg + gamma[b] * cb
    fy = _table(_CBRT_TAB, bgr.device)[(y + (1 << (_LAB_SHIFT - 1))) >> _LAB_SHIFT]
    lum = (_L_SCALE * fy + _L_SHIFT + (1 << (_LAB_SHIFT2 - 1))) >> _LAB_SHIFT2
    return lum.clamp(0, 255).to(torch.uint8)


def in_range(channels, lo, hi) -> torch.Tensor:
    """cv2.inRange over per-channel planes: every channel within [lo, hi]."""
    out = None
    for c, a, z in zip(channels, lo, hi, strict=True):
        m = (c >= a) & (c <= z)
        out = m if out is None else out & m
    return out


# --------------------------------------------------------------------------
# rounding and borders
# --------------------------------------------------------------------------

def round_u8(x: torch.Tensor) -> torch.Tensor:
    """saturate_cast<uchar>(float): round half to even, clamp to 0..255."""
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def _pad(img: torch.Tensor, top: int, bottom: int, left: int, right: int,
         mode: str) -> torch.Tensor:
    """A 2-D tensor padded as OpenCV's BORDER_REFLECT_101 ("reflect") or
    BORDER_REPLICATE ("replicate")."""
    x = img[None, None].to(torch.float32)
    return F.pad(x, (left, right, top, bottom), mode=mode)[0, 0]


# --------------------------------------------------------------------------
# CLAHE
# --------------------------------------------------------------------------

def clahe(gray: torch.Tensor, clip_limit: float = 2.0, tiles: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """cv2.createCLAHE(clipLimit, tileGridSize=tiles).apply(gray) on uint8.

    OpenCV pads an image whose sides are not both multiples of the tile
    grid on the bottom and right (BORDER_REFLECT_101), by ``tiles - side %
    tiles`` on each side (a whole tile where that side divides). Each
    tile's histogram is clipped at ``int(clip * area / 256)``, the excess
    spread evenly and its remainder one count every ``256 // residual``
    bins; the LUT is the running sum times 255 / area, rounded. Pixels
    interpolate the four nearest tiles' LUTs bilinearly in float32.
    """
    tx, ty = tiles
    h, w = gray.shape
    dev = gray.device
    if w % tx == 0 and h % ty == 0:
        ext = gray.to(torch.int64)
    else:
        ext = _pad(gray, 0, ty - h % ty, 0, tx - w % tx, "reflect").to(torch.int64)
    th, tw = ext.shape[0] // ty, ext.shape[1] // tx
    area = th * tw
    n_tiles = tx * ty
    ids = ext.view(ty, th, tx, tw).permute(0, 2, 1, 3).reshape(n_tiles, area)
    ids = ids + torch.arange(n_tiles, device=dev)[:, None] * 256
    hist = torch.bincount(ids.reshape(-1), minlength=n_tiles * 256).view(n_tiles, 256)
    if clip_limit > 0:
        clip = max(int(clip_limit * area / 256), 1)
        excess = (hist - clip).clamp(min=0).sum(1, keepdim=True)
        hist = hist.clamp(max=clip)
        batch = excess // 256
        residual = excess - batch * 256
        step = torch.where(residual > 0, (256 // residual.clamp(min=1)).clamp(min=1), 1)
        i = torch.arange(256, device=dev)[None]
        hist = hist + batch + ((i % step == 0) & (i // step < residual)).to(hist.dtype)
    scale = torch.tensor(255.0, dtype=torch.float32) / torch.tensor(float(area), dtype=torch.float32)
    lut = round_u8(torch.cumsum(hist, 1).to(torch.float32) * scale.to(dev)).to(torch.int64)
    lut = lut.reshape(-1)

    def weights(n: int, size: int, count: int):
        inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(size), dtype=torch.float32)
        t = torch.arange(n, dtype=torch.float32, device=dev) * inv.to(dev) - 0.5
        t1 = torch.floor(t)
        a = t - t1
        t1 = t1.to(torch.int64)
        return t1.clamp(min=0), (t1 + 1).clamp(max=count - 1), a, 1.0 - a

    x1, x2, xa, xa1 = weights(w, tw, tx)
    y1, y2, ya, ya1 = weights(h, th, ty)
    v = gray.to(torch.int64)
    row1, row2 = (y1 * tx)[:, None], (y2 * tx)[:, None]

    def at(row, col):
        return lut[(row + col[None]) * 256 + v].to(torch.float32)

    top = at(row1, x1) * xa1 + at(row1, x2) * xa
    bottom = at(row2, x1) * xa1 + at(row2, x2) * xa
    return round_u8(top * ya1[:, None] + bottom * ya[:, None])


# --------------------------------------------------------------------------
# bilateral filter
# --------------------------------------------------------------------------

def _bilateral_taps(d: int, sigma_space: float) -> List[Tuple[int, int, float]]:
    radius = max(d // 2, 1) if d > 0 else max(round(sigma_space * 1.5), 1)
    coeff = -0.5 / (sigma_space * sigma_space)
    taps = []
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r = math.sqrt(float(i * i + j * j))
            if r > radius:
                continue
            taps.append((i, j, float(np.float32(math.exp(r * r * coeff)))))
    return taps


def bilateral_filter(gray: torch.Tensor, d: int = 9, sigma_color: float = 75.0,
                     sigma_space: float = 75.0) -> torch.Tensor:
    """cv2.bilateralFilter(gray, d, sigma_color, sigma_space) on one uint8 channel.

    The window is the disc of radius d // 2 (49 taps at d = 9), visited in
    OpenCV's order (rows, then columns); the colour weight is a float32
    table by |difference|, the border BORDER_REFLECT_101. The weighted sum
    and the weight total accumulate in float32 tap by tap, and the result
    is their quotient rounded half to even.
    """
    taps = _bilateral_taps(d, sigma_space)
    radius = max(abs(i) for i, _, _ in taps)
    coeff = -0.5 / (sigma_color * sigma_color)
    color = torch.tensor([math.exp(i * i * coeff) for i in range(256)],
                         dtype=torch.float32, device=gray.device)
    h, w = gray.shape
    padded = _pad(gray, radius, radius, radius, radius, "reflect")
    centre = gray.to(torch.float32)
    total = torch.zeros_like(centre)
    wsum = torch.zeros_like(centre)
    for i, j, space in taps:
        val = padded[radius + i: radius + i + h, radius + j: radius + j + w]
        wgt = color[(val - centre).abs().to(torch.int64)] * space
        wsum += wgt
        total += val * wgt
    return round_u8(total / wsum)


# --------------------------------------------------------------------------
# Canny
# --------------------------------------------------------------------------

_TG22 = int(0.4142135623730950488016887242097 * (1 << 15) + 0.5)


def sobel3(gray: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel dx, dy (int32) with BORDER_REPLICATE, as Canny takes them."""
    p = _pad(gray, 1, 1, 1, 1, "replicate")
    h, w = gray.shape

    def s(dy, dx):
        return p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]

    gx = (s(-1, 1) - s(-1, -1)) + 2 * (s(0, 1) - s(0, -1)) + (s(1, 1) - s(1, -1))
    gy = (s(1, -1) - s(-1, -1)) + 2 * (s(1, 0) - s(-1, 0)) + (s(1, 1) - s(-1, 1))
    return gx.to(torch.int32), gy.to(torch.int32)


def _max3(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x[None, None], 3, stride=1, padding=1)[0, 0]


def hysteresis(strong: torch.Tensor, weak: torch.Tensor, rounds: int = 16) -> torch.Tensor:
    """The pixels of ``weak`` 8-connected through ``weak`` to a pixel of
    ``strong`` (strong lies in weak): geodesic dilation to a fixed point,
    checked once every ``rounds`` dilations."""
    edge = strong.to(torch.float32)
    keep = weak.to(torch.float32)
    while True:
        before = edge
        for _ in range(rounds):
            edge = _max3(edge) * keep
        if torch.equal(edge, before):
            return edge.bool()


def canny(gray: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """cv2.Canny(gray, low, high) with aperture 3 and the L1 gradient.

    Non-maximum suppression follows OpenCV's integer sector test (tan 22.5
    degrees at 15 bits) with its strict and non-strict comparisons; the
    magnitude outside the image is 0. Edges are the suppressed pixels above
    ``low`` 8-connected to one above ``high``.
    """
    lo, hi = math.floor(low), math.floor(high)
    if lo > hi:
        lo, hi = hi, lo
    gx, gy = sobel3(gray)
    mag = gx.abs() + gy.abs()
    m = F.pad(mag, (1, 1, 1, 1))
    h, w = gray.shape

    def at(dy, dx):
        return m[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]

    ax = gx.abs()
    ay = gy.abs() << 15
    tg22 = ax * _TG22
    tg67 = tg22 + (ax << 16)
    horizontal = (mag > at(0, -1)) & (mag >= at(0, 1))
    vertical = (mag > at(-1, 0)) & (mag >= at(1, 0))
    same_sign = (gx ^ gy) >= 0
    # s = +1: the previous row's left neighbour and the next row's right one
    diag = torch.where(same_sign, (mag > at(-1, -1)) & (mag > at(1, 1)),
                       (mag > at(-1, 1)) & (mag > at(1, -1)))
    peak = torch.where(ay < tg22, horizontal, torch.where(ay > tg67, vertical, diag))
    weak = peak & (mag > lo)
    return hysteresis(weak & (mag > hi), weak)


# --------------------------------------------------------------------------
# morphology, Gaussian adaptive threshold, min-max normalise
# --------------------------------------------------------------------------

def dilate(mask: torch.Tensor, k: int) -> torch.Tensor:
    """cv2.dilate with a k x k box (odd k); the border never dilates."""
    x = mask.to(torch.float32)[None, None]
    return F.max_pool2d(x, k, stride=1, padding=k // 2)[0, 0].bool()


def erode(mask: torch.Tensor, k: int) -> torch.Tensor:
    """cv2.erode with a k x k box (odd k); the border never erodes."""
    return ~dilate(~mask, k)


def morph_close(mask: torch.Tensor, k: int) -> torch.Tensor:
    return erode(dilate(mask, k), k)


def morph_open(mask: torch.Tensor, k: int) -> torch.Tensor:
    return dilate(erode(mask, k), k)


def gaussian_kernel(ksize: int, sigma: float = 0.0) -> List[float]:
    """cv2.getGaussianKernel(ksize, sigma, CV_32F) for ksize > 7 (or sigma > 0)."""
    if sigma <= 0:
        sigma = ((ksize - 1) * 0.5 - 1) * 0.3 + 0.8
    coeff = -0.5 / (sigma * sigma)
    t = [math.exp(coeff * (i - (ksize - 1) * 0.5) ** 2) for i in range(ksize)]
    total = sum(t)
    return [float(np.float32(v / total)) for v in t]


def gaussian_blur_f32(img: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """cv2.GaussianBlur of a float32 plane, BORDER_REPLICATE: rows, then
    columns, each tap in float32."""
    k = gaussian_kernel(ksize, sigma)
    r = ksize // 2
    h, w = img.shape
    p = _pad(img, r, r, r, r, "replicate")
    rows = torch.zeros((h + 2 * r, w), dtype=torch.float32, device=img.device)
    for j, c in enumerate(k):
        rows += p[:, j: j + w] * c
    out = rows[r: r + h] * k[r]
    for i in range(1, r + 1):
        out += (rows[r - i: r - i + h] + rows[r + i: r + i + h]) * k[r + i]
    return out


def adaptive_threshold_gaussian_inv(gray: torch.Tensor, block: int, c: float) -> torch.Tensor:
    """cv2.adaptiveThreshold(gray, 255, ADAPTIVE_THRESH_GAUSSIAN_C,
    THRESH_BINARY_INV, block, c): the Gaussian mean rounded to uint8, and
    pixels with src - mean <= -floor(c)."""
    mean = round_u8(gaussian_blur_f32(gray.to(torch.float32), block)).to(torch.int32)
    return gray.to(torch.int32) - mean <= -math.floor(c)


def minmax_normalize_u8(x: torch.Tensor) -> torch.Tensor:
    """cv2.normalize(x, None, 0, 255, NORM_MINMAX) of an integer-valued
    float64 plane, then ``astype(uint8)`` (truncation).

    OpenCV computes ``x * scale + shift`` as one fused multiply-add in
    float64; the plane holds few distinct integers, so each is mapped once
    on the host through the exactly rounded fused value and the plane is
    gathered from that table.
    """
    lo, hi = int(x.min()), int(x.max())
    scale = 255.0 * (1.0 / (hi - lo)) if hi - lo > np.finfo(np.float64).eps else 0.0
    shift = 0.0 - lo * scale
    fs, fh = Fraction(scale), Fraction(shift)
    lut = [min(max(int(float(v * fs + fh)), 0), 255) for v in range(lo, hi + 1)]
    table = torch.tensor(lut, dtype=torch.uint8, device=x.device)
    return table[(x - lo).to(torch.int64)]


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=INTER_NEAREST)."""
    h, w = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(width) * (w / width)).astype(np.int64), w - 1)
    sy = np.minimum(np.floor(np.arange(height) * (h / height)).astype(np.int64), h - 1)
    return img[sy[:, None], sx[None, :]]


# --------------------------------------------------------------------------
# host side: the probabilistic Hough transform, thick lines, contour fill
# --------------------------------------------------------------------------

class CvRNG:
    """OpenCV's ``cv::RNG``: a 64-bit multiply-with-carry generator.

    HoughLinesP draws its point order from ``RNG((uint64)-1)``; seeded the
    same way this generator draws the same numbers, so the Hough walk
    visits the edge points in OpenCV's order. It holds its own state and
    touches no global generator.
    """

    def __init__(self, seed: int = 0xFFFFFFFFFFFFFFFF):
        self.state = seed & 0xFFFFFFFFFFFFFFFF or 0xFFFFFFFF

    def next(self) -> int:
        self.state = ((self.state & 0xFFFFFFFF) * 4164903690 + (self.state >> 32)) & 0xFFFFFFFFFFFFFFFF
        return self.state & 0xFFFFFFFF

    def uniform(self, a: int, b: int) -> int:
        return a if a == b else a + self.next() % (b - a)


def _visit_order(count: int, rng: CvRNG) -> np.ndarray:
    """The order in which HoughLinesP takes its points: a random pick of the
    remaining ones, the last moved into the picked slot."""
    slots = list(range(count))
    order = np.empty(count, np.int64)
    for k, c in enumerate(range(count, 0, -1)):
        i = rng.uniform(0, c)
        order[k] = slots[i]
        slots[i] = slots[c - 1]
    return order


def _num_angles(theta: float) -> int:
    n = math.floor(math.pi / theta) + 1
    if n > 1 and abs(math.pi - (n - 1) * theta) < theta / 2:
        n -= 1
    return n


def _first_gap_end(on: np.ndarray, max_gap: int) -> int:
    """Index of the last set step before the walk meets more than
    ``max_gap`` unset steps in a row (step 0 is set)."""
    idx = np.flatnonzero(on)
    jumps = np.flatnonzero(np.diff(idx) - 1 > max_gap)
    return int(idx[jumps[0]] if len(jumps) else idx[-1])


def hough_lines_p(edges: torch.Tensor, theta: float, threshold: int, min_length: int,
                  max_gap: int, rng: CvRNG, chunk: Optional[int] = None
                  ) -> List[Tuple[int, int, int, int]]:
    """cv2.HoughLinesP(edges, rho=1, theta, threshold, minLineLength,
    maxLineGap) with OpenCV's point order drawn from ``rng``.

    The edge points are taken in the order the generator gives; each
    votes once per angle (float32 ``x cos + y sin``, rounded half to even),
    and the first vote that lifts a bin to ``threshold`` walks the line in
    16-bit fixed point both ways until a gap longer than ``max_gap``,
    clearing its points (and, for a line at least ``min_length`` long in x
    or y, withdrawing their votes). The votes run on the edges' device,
    ``chunk`` points of the order at a time: a bin the chunk lifts to the
    threshold is the only one that can trigger, so only its votes are
    ranked (on the host) to find the first point that does, and the chunk
    is cast up to that point. The walk runs on the host.
    """
    dev = edges.device
    h, w = edges.shape
    pix = torch.nonzero(edges.reshape(-1)).squeeze(1)  # row-major, OpenCV's list
    count = pix.numel()
    if count == 0:
        return []
    chunk = chunk or (8192 if dev.type == "cuda" else 512)
    pts = pix[torch.from_numpy(_visit_order(count, rng)).to(dev)]
    xs, ys = pts % w, pts // w
    n_ang = _num_angles(theta)
    n_rho = round((w + h) * 2 + 1)
    cos = np.array([math.cos(k * theta) for k in range(n_ang)], np.float32)
    sin = np.array([math.sin(k * theta) for k in range(n_ang)], np.float32)
    base = torch.arange(n_ang, device=dev) * n_rho + (n_rho - 1) // 2
    r = (xs.to(torch.float32)[:, None] * torch.from_numpy(cos).to(dev)
         + ys.to(torch.float32)[:, None] * torch.from_numpy(sin).to(dev))
    bins = torch.round(r).to(torch.int64) + base  # [count, n_ang], in visiting order
    del r
    acc = torch.zeros(n_ang * n_rho, dtype=torch.int32, device=dev)
    alive = torch.ones(count, dtype=torch.bool, device=dev)
    # the walk's view on the host: the edge mask and each pixel's place in the order
    mask = edges.cpu().numpy().astype(bool)
    pts_host = pts.cpu().numpy()
    place = np.full(h * w, -1, np.int64)
    place[pts_host] = np.arange(count)

    lines: List[Tuple[int, int, int, int]] = []
    seen = torch.zeros_like(acc)  # the chunk's votes per bin, zeroed after use
    pos = 0
    while pos < count:
        end = min(pos + chunk, count)
        flat = bins[pos:end].reshape(-1)
        live = alive[pos:end, None].expand(end - pos, n_ang).reshape(-1).to(torch.int32)
        before = acc[flat]
        seen.index_add_(0, flat, live)
        # only a bin the chunk lifts to the threshold can trigger
        hot = torch.nonzero((before + seen[flat] >= threshold) & (live > 0)).squeeze(1)
        seen[flat] = 0
        t = -1
        if hot.numel():
            hot_flat, hot_before, hot = (v.cpu().numpy() for v in (flat[hot], before[hot], hot))
            srt = np.argsort(hot_flat, kind="stable")  # hot is in point order already
            group = np.r_[True, hot_flat[srt][1:] != hot_flat[srt][:-1]]
            rank = np.empty(len(srt), np.int64)
            rank[srt] = np.arange(len(srt)) - np.maximum.accumulate(
                np.where(group, np.arange(len(srt)), 0))
            val = hot_before + rank + 1
            reach = val >= threshold
            if reach.any():
                t = int(hot[reach].min()) // n_ang
                at = hot // n_ang == t
                n = int((hot[at] % n_ang)[val[at] == val[at].max()].min())
        take = end - pos if t < 0 else t + 1
        acc.index_add_(0, flat[: take * n_ang], live[: take * n_ang])
        if t >= 0:
            p = int(pts_host[pos + t])
            good, (cy, cx) = _walk(mask, p % w, p // w, -sin[n], cos[n], min_length, max_gap)
            gone = torch.from_numpy(place[cy * w + cx]).to(dev)
            alive[gone] = False
            if good is not None:
                lines.append(good)
                acc.index_add_(0, bins[gone].reshape(-1), torch.full(
                    (gone.numel() * n_ang,), -1, dtype=torch.int32, device=dev))
        pos += take
    return lines


def _walk(mask, j, i, a: np.float32, b: np.float32, min_length, max_gap):
    """HoughLinesP's walk from (j, i) along the float32 direction (a, b) in
    16-bit fixed point, both ways. Clears the walked points of ``mask``;
    returns the segment if it is long enough (else None) and the cleared
    points."""
    h, w = mask.shape
    shift = 16
    one = np.float32(1 << shift)
    if abs(a) > abs(b):
        xflag, dx0 = True, (1 if a > 0 else -1)
        dy0 = round(float(b * one / abs(a)))
        x0, y0 = j, (i << shift) + (1 << (shift - 1))
    else:
        xflag, dy0 = False, (1 if b > 0 else -1)
        dx0 = round(float(a * one / abs(b)))
        x0, y0 = (j << shift) + (1 << (shift - 1)), i
    walks, ends = [], []
    for sgn in (1, -1):
        dx, dy = dx0 * sgn, dy0 * sgn
        # steps until the walk leaves the image
        if xflag:
            steps = (w - 1 - x0) // dx + 1 if dx > 0 else x0 // -dx + 1
        else:
            steps = (h - 1 - y0) // dy + 1 if dy > 0 else y0 // -dy + 1
        k = np.arange(steps, dtype=np.int64)
        x, y = x0 + k * dx, y0 + k * dy
        jj, ii = (x, y >> shift) if xflag else (x >> shift, y)
        inside = (jj >= 0) & (jj < w) & (ii >= 0) & (ii < h)
        if not inside.all():
            stop = int(np.argmin(inside))
            jj, ii = jj[:stop], ii[:stop]
        end = _first_gap_end(mask[ii, jj], max_gap)
        walks.append((jj[: end + 1], ii[: end + 1]))
        ends.append((int(jj[end]), int(ii[end])))
    (x1, y1), (x2, y2) = ends
    good = abs(x2 - x1) >= min_length or abs(y2 - y1) >= min_length
    cx = np.concatenate([walks[0][0], walks[1][0]])
    cy = np.concatenate([walks[0][1], walks[1][1]])
    on = mask[cy, cx]
    cx, cy = cx[on], cy[on]
    # the start point is on both walks: count it once
    keep = np.ones(len(cx), bool)
    dup = np.flatnonzero((cx == j) & (cy == i))
    keep[dup[1:]] = False
    cx, cy = cx[keep], cy[keep]
    mask[cy, cx] = False
    return ((x1, y1, x2, y2) if good else None), (cy, cx)


_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _hline(mask: np.ndarray, y: int, x1: int, x2: int) -> None:
    h, w = mask.shape
    if 0 <= y < h and x2 >= 0 and x1 < w:
        mask[y, max(x1, 0): min(x2, w - 1) + 1] = True


def _clip_line(w: int, h: int, p1: List[int], p2: List[int]) -> bool:
    """OpenCV's clipLine to [0, w-1] x [0, h-1], in place."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    p1[:], p2[:] = [x1, y1], [x2, y2]
    return (c1 | c2) == 0


def _line_fixed(mask: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int]) -> None:
    """OpenCV's Line2: an 8-connected line between 16.16 fixed-point ends."""
    h, w = mask.shape
    a, b = list(p1), list(p2)
    if not _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, a, b):
        return
    (x1, y1), (x2, y2) = a, b
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
        x_step, y_step = _XY_ONE, _cdiv(dy << _XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> _XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2, dx = x2, y2, x1, y1, -dx
        x_step, y_step = _cdiv(dx << _XY_SHIFT, abs(dy) | 1), _XY_ONE
        count = (y2 - y1) >> _XY_SHIFT
    half = _XY_ONE >> 1
    px, py = (x2 + half) >> _XY_SHIFT, (y2 + half) >> _XY_SHIFT
    if 0 <= px < w and 0 <= py < h:
        mask[py, px] = True
    k = np.arange(count + 1, dtype=np.int64)
    x1, y1 = x1 + half, y1 + half
    if x_step == _XY_ONE:
        xs, ys = (x1 >> _XY_SHIFT) + k, (y1 + k * y_step) >> _XY_SHIFT
    else:
        xs, ys = (x1 + k * x_step) >> _XY_SHIFT, (y1 >> _XY_SHIFT) + k
    on = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    mask[ys[on], xs[on]] = True


def _fill_convex_poly(mask: np.ndarray, pts: List[Tuple[int, int]]) -> None:
    """OpenCV's FillConvexPoly for LINE_8 at 16 fractional bits: the outline's
    8-connected lines, then the scanlines between the two edge walkers."""
    h, w = mask.shape
    n = len(pts)
    delta = _XY_ONE >> 1
    prev = pts[-1]
    for p in pts:
        _line_fixed(mask, prev, p)
        prev = p
    ys = [p[1] for p in pts]
    xs = [p[0] for p in pts]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + delta) >> _XY_SHIFT, (max(xs) + delta) >> _XY_SHIFT
    ymin, ymax = (min(ys) + delta) >> _XY_SHIFT, (max(ys) + delta) >> _XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    edge = [{"idx": imin, "di": 1, "x": -_XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": n - 1, "x": -_XY_ONE, "dx": 0, "ye": ymin}]
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (pts[idx][1] + delta) >> _XY_SHIFT
                    if ty > y:
                        xs_, xe = pts[idx0][0], pts[idx][0]
                        e.update(ye=ty, dx=_cdiv((xe - xs_) * 2 + (ty - y), 2 * (ty - y)),
                                 x=xs_, idx=idx)
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            _hline(mask, y, (edge[left]["x"] + delta) >> _XY_SHIFT,
                   (edge[right]["x"] + delta) >> _XY_SHIFT)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _fill_circle(mask: np.ndarray, cx: int, cy: int, radius: int) -> None:
    """OpenCV's filled Circle (midpoint, scanlines)."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, x1, x2 in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            _hline(mask, y, x1, x2)
        dy += 1
        err += plus
        plus += 2
        m = (err <= 0) - 1
        err -= minus & m
        dx += m
        minus -= m & 2


def draw_thick_line(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int, thickness: int) -> None:
    """cv2.line(mask, (x1, y1), (x2, y2), 255, thickness, LINE_8) for
    thickness > 1, in place on a bool mask: OpenCV's ThickLine, a convex
    quadrilateral of half-width (thickness + thickness % 2) / 2 in 16.16
    fixed point and a filled circle at each end."""
    p0 = (x1 << _XY_SHIFT, y1 << _XY_SHIFT)
    p1 = (x2 << _XY_SHIFT, y2 << _XY_SHIFT)
    dx = (p0[0] - p1[0]) / _XY_ONE
    dy = (p1[1] - p0[1]) / _XY_ONE
    r2 = dx * dx + dy * dy
    half = thickness << (_XY_SHIFT - 1)
    if abs(r2) > np.finfo(np.float64).eps:
        r = (half + (thickness & 1) * _XY_ONE * 0.5) / math.sqrt(r2)
        ex, ey = round(dy * r), round(dx * r)
        _fill_convex_poly(mask, [(p0[0] + ex, p0[1] + ey), (p0[0] - ex, p0[1] - ey),
                                 (p1[0] - ex, p1[1] - ey), (p1[0] + ex, p1[1] + ey)])
    radius = (half + (_XY_ONE >> 1)) >> _XY_SHIFT
    for x, y in ((x1, y1), (x2, y2)):
        _fill_circle(mask, x, y, radius)


def keep_large_contours(mask: torch.Tensor, min_area: float) -> torch.Tensor:
    """findContours(RETR_EXTERNAL) + a filled drawContours of every contour
    whose contourArea exceeds ``min_area``, on a bool mask.

    An external contour bounds one 8-connected component with its holes
    (background is 4-connected); the filled contour is that component
    with its holes filled. contourArea is the shoelace area of the
    boundary through pixel centres, which for a hole-free 8-connected
    region is the number of 2x2 pixel windows it fills plus half the
    number it fills three quarters of (a filled k x k square has
    (k - 1)^2). The components are labelled on the host (scipy); the
    windows are counted and the kept ones drawn on the mask's device.
    """
    from scipy import ndimage

    host = mask.cpu().numpy()
    background, nb = ndimage.label(~host)  # 4-connected
    rim = np.concatenate([background[0], background[-1], background[:, 0], background[:, -1]])
    outside = np.zeros(nb + 1, bool)
    outside[rim] = True
    labels, n = ndimage.label(host | ~outside[background], structure=np.ones((3, 3), bool))
    if n == 0:
        return torch.zeros_like(mask, dtype=torch.bool)
    lab = torch.from_numpy(labels).to(mask.device)
    pad = F.pad(lab, (1, 1, 1, 1))
    quad = (pad[:-1, :-1], pad[:-1, 1:], pad[1:, :-1], pad[1:, 1:])
    corners = sum((q > 0).to(torch.int8) for q in quad)
    owner = torch.maximum(torch.maximum(quad[0], quad[1]), torch.maximum(quad[2], quad[3]))
    half_windows = (2.0 * (corners == 4) + (corners == 3)).to(torch.float64)
    twice_area = torch.bincount(owner.reshape(-1).long(), half_windows.reshape(-1),
                                minlength=n + 1)
    keep = twice_area > 2 * min_area
    keep[0] = False
    return keep[lab.long()]
