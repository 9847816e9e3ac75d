"""K1: 2x bilinear upsample and its adjoint, CUDA kernels and their plain versions.

Replaces terra_gan_tpu/ops/pallas/upsample_kernel.py ::
upsample2x_fwd_pallas (``_up_fwd``, body ``_fwd_kernel``) and
upsample2x_bwd_pallas (``_up_bwd``, body ``_bwd_kernel``). The kernels
are ``csrc/upsample2x.cu``: NHWC, fp32 and bf16 storage with fp32 taps,
16-byte accesses (C a multiple of 4 in fp32, of 8 in bf16), bound by
device-memory bytes (one read, one write); the source note there gives the
design. ``plan_upsample`` gives each launch's tiling from the shape alone,
and splits a batch whose 2x side would pass 2^31 - 1 elements, so that
every index in a kernel is an int. The forward evaluates torch's own
expression for the taps, so on a card its fp32 result is torch's to the
bit. The plain versions are torch's own ``F.interpolate(...,
mode="bilinear", align_corners=False)`` and its autograd backward.

``upsample2x_fwd`` and ``upsample2x_bwd`` take the plain version only
for a tensor on the CPU; for a CUDA tensor they launch the kernel or
raise. Neither records a graph: under autograd the upsample is
``Upsample2x`` (``ops.resize.upsample2x_bilinear``), whose backward is
``upsample2x_bwd``, and the raw forward raises on a CUDA tensor that
requires grad rather than cut the gradient silently.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ._build import check, load_library

_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}
INT_MAX = 2**31 - 1
MAX_THREADS = 256  # a block's most threads


class UpsamplePlan(NamedTuple):
    """How a K1 call launches (csrc/upsample2x.cu's Upsample2xTiles): a
    thread takes one channel group of one column of ``rows`` rows (the
    forward one input pixel; the adjoint 1 or 2 dx rows); a block of
    ``block`` = gb * rt * ht threads takes ``gb`` channel groups (one of
    ``slices`` slices of them) of a tile of ``rt`` columns across and
    ``ht`` row blocks down, ``tiles_w`` by ``tiles_h`` tiles an image;
    one launch per ``chunks`` entry (n0, nb, grid): images n0 .. n0+nb-1,
    a grid of ``grid`` by ``slices`` blocks."""

    direction: str
    vec: int
    rows: int
    gb: int
    slices: int
    rt: int
    ht: int
    tiles_w: int
    tiles_h: int
    block: int
    chunks: Tuple[Tuple[int, int, int], ...]


class _Tiles(ctypes.Structure):
    """csrc/upsample2x.cu's Upsample2xTiles, field for field."""

    _fields_ = [(f, ctypes.c_int) for f in
                ("rows", "gb", "slices", "rt", "ht", "tiles_w", "tiles_h", "block")]


def _tiling(direction: str, n: int, h: int, w: int, c: int, dtype: torch.dtype, rows: int,
            ht: int) -> UpsamplePlan:
    """The launches that tile [n, h, w, c] (the small side) with ``rows``
    rows a thread and at most ``ht`` row blocks a tile; plan_upsample
    picks these."""
    vec = _DTYPES[dtype][1]
    groups = c // vec
    slices = -(-groups // MAX_THREADS)
    gb = -(-groups // slices)
    row_blocks = -(-h // rows)
    ht = min(ht, MAX_THREADS // gb, row_blocks)
    rt = min(MAX_THREADS // (gb * ht), w)
    tiles_w, tiles_h = -(-w // rt), -(-row_blocks // ht)
    per_launch = INT_MAX // (4 * h * w * c)
    chunks = tuple((n0, min(per_launch, n - n0), min(per_launch, n - n0) * tiles_h * tiles_w)
                   for n0 in range(0, n, per_launch))
    return UpsamplePlan(direction, vec, rows, gb, slices, rt, ht, tiles_w, tiles_h,
                        gb * rt * ht, chunks)


@functools.lru_cache(maxsize=None)
def plan_upsample(direction: str, n: int, h: int, w: int, c: int,
                  dtype: torch.dtype) -> UpsamplePlan:
    """The launches of K1 ``direction`` ("fwd" or "bwd") at the small side
    [n, h, w, c] in ``dtype``; a pure function of the shape.

    A thread takes one group of VEC channels (4 fp32, 8 bf16) of one
    column: the forward one input pixel; the adjoint 2 dx rows (they share
    2 of their 6 g rows), 1 where dx is at most 8 x 8. A block takes the
    channel groups, up to 256 of them (wider C is sliced over
    blockIdx.y), of a tile 4 row blocks down in the forward, 2 in the
    adjoint (fewer where the groups or the rows run out), and as many
    columns across as fill MAX_THREADS threads: chosen from the
    alternatives that profile_slice.py --legs k1 times at the decoder's
    shapes at batch 8 on an H100 (PERF.md, Findings). Each launch holds at
    most INT_MAX elements of the 2x side; raises where one image alone
    holds more.
    """
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"plan_upsample: direction {direction!r}, not 'fwd' or 'bwd'")
    if dtype not in _DTYPES:
        raise ValueError(f"plan_upsample: {dtype}, not float32 or bfloat16")
    vec = _DTYPES[dtype][1]
    if min(n, h, w, c) < 1 or c % vec:
        raise ValueError(f"plan_upsample: shape {(n, h, w, c)} with C % {vec} != 0 or empty")
    if 4 * h * w * c > INT_MAX:
        raise ValueError(f"plan_upsample: one image's 2x side holds {4 * h * w * c} elements, "
                         f"above the kernel's 32-bit indices ({INT_MAX})")
    if direction == "fwd":
        return _tiling(direction, n, h, w, c, dtype, 1, 4)
    small = h <= 8 and w <= 8  # launch-sized: the shortest thread
    return _tiling(direction, n, h, w, c, dtype, 1 if small else 2, 2)


def upsample2x_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> [N,2H,2W,C] through F.interpolate."""
    y = F.interpolate(
        x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
        align_corners=False,
    )
    return y.permute(0, 2, 3, 1).contiguous()


def upsample2x_bwd_plain(g: torch.Tensor) -> torch.Tensor:
    """[N,2H,2W,C] -> [N,H,W,C]: the op autograd runs as the backward of
    ``upsample2x_fwd_plain`` (F.interpolate passes the scale factors on)."""
    n, h2, w2, c = g.shape
    dx = torch.ops.aten.upsample_bilinear2d_backward(
        g.permute(0, 3, 1, 2), [h2, w2], [n, c, h2 // 2, w2 // 2], False, 2.0, 2.0
    )
    return dx.permute(0, 2, 3, 1).contiguous()


def _launch_args(plan: UpsamplePlan, h: int, w: int, c: int, dtype: torch.dtype):
    """Per launch of ``plan``: (src byte offset, dst byte offset, the C
    entry's arguments after the pointers but the stream), beside the
    Upsample2xTiles they point to, which the caller keeps alive."""
    code = _DTYPES[dtype][0]
    tiles = _Tiles(**{f: getattr(plan, f) for f, _ in _Tiles._fields_})
    small = h * w * c * dtype.itemsize  # an image's bytes on the small side
    src_img, dst_img = (small, 4 * small) if plan.direction == "fwd" else (4 * small, small)
    return tiles, tuple((n0 * src_img, n0 * dst_img,
                         (nb, h, w, c, code, ctypes.addressof(tiles), grid))
                        for n0, nb, grid in plan.chunks)


@functools.lru_cache(maxsize=None)
def _launches(entry: str, n: int, h: int, w: int, c: int, dtype: torch.dtype):
    """The bound C entry ``tg_<entry>`` and plan_upsample's _launch_args;
    looked up once a shape."""
    plan = plan_upsample(entry[-3:], n, h, w, c, dtype)
    return getattr(load_library(), f"tg_{entry}"), _launch_args(plan, h, w, c, dtype)


def _launch(wrapper, src: torch.Tensor, dst: torch.Tensor, small) -> None:
    """Check what the kernel takes, then launch ``wrapper``'s kernel from src
    into dst as plan_upsample plans it, counting each launch in
    ``wrapper.launches``; an empty dst launches nothing and counts nothing.

    ``small`` is the (N, H, W, C) of the low-resolution side.
    """
    entry = wrapper.__name__
    if src.dim() != 4 or src.dtype not in _DTYPES or not src.is_contiguous():
        raise ValueError(
            f"{entry}: needs a contiguous NHWC fp32 or bf16 tensor, got "
            f"{tuple(src.shape)} {src.dtype} contiguous={src.is_contiguous()}"
        )
    vec = _DTYPES[src.dtype][1]
    n, h, w, c = small
    src_ptr, dst_ptr = src.data_ptr(), dst.data_ptr()
    if c % vec or (src_ptr | dst_ptr) % 16:
        raise ValueError(
            f"{entry}: the kernel moves {vec} channels of {src.dtype} at a "
            f"time; needs C % {vec} == 0 (C = {c}) and 16-byte aligned tensors"
        )
    if dst.numel() == 0:
        return
    fn, (_, launches) = _launches(entry, n, h, w, c, src.dtype)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        for src_off, dst_off, args in launches:
            check(fn(src_ptr + src_off, dst_ptr + dst_off, *args, stream), entry)
            wrapper.launches += 1


def _check_device(t: torch.Tensor, entry: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{entry}: no kernel for device {t.device}")


def upsample2x_fwd(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x bilinear upsample (torch ``align_corners=False`` taps)."""
    if x.device.type == "cpu":
        return upsample2x_fwd_plain(x)
    _check_device(x, "upsample2x_fwd")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            "upsample2x_fwd: the kernel records no gradient; under autograd "
            "use Upsample2x.apply (ops.resize.upsample2x_bilinear)"
        )
    n, h, w, c = x.shape
    y = torch.empty((n, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    _launch(upsample2x_fwd, x, y, (n, h, w, c))
    return y


def upsample2x_bwd(g: torch.Tensor) -> torch.Tensor:
    """The exact adjoint of ``upsample2x_fwd``: NHWC [N,2H,2W,C] -> [N,H,W,C]."""
    if g.device.type == "cpu":
        return upsample2x_bwd_plain(g)
    _check_device(g, "upsample2x_bwd")
    n, h2, w2, c = g.shape
    if h2 % 2 or w2 % 2:
        raise ValueError(f"upsample2x_bwd: needs an even height and width, got {h2}x{w2}")
    dx = torch.empty((n, h2 // 2, w2 // 2, c), dtype=g.dtype, device=g.device)
    _launch(upsample2x_bwd, g, dx, (n, h2 // 2, w2 // 2, c))
    return dx


upsample2x_fwd.launches = 0
upsample2x_bwd.launches = 0


class Upsample2x(torch.autograd.Function):
    """NHWC 2x bilinear upsample whose backward is ``upsample2x_bwd``.

    The counterpart of the JAX package's ``custom_vjp``
    (terra_gan_tpu/ops/resize.py :: upsample2x_bilinear): K1 forward and
    K1 backward on a card, the plain versions on the CPU.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return upsample2x_fwd(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        # the gradient arrives from pad_to_match and a cuDNN conv backward,
        # not always contiguous in NHWC; K1 reads it as such
        return upsample2x_bwd(g.contiguous())
