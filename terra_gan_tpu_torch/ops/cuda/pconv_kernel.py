"""K2: the fused PConv stage, CUDA kernel and its plain version, in eval and train mode.

Replaces terra_gan_tpu/ops/pallas/pconv_kernel.py :: fused_pconv_eval
(``_kernel_s1``, ``_kernel_s2``, ``_epilogue``, and the tall-stage strip
form ``_strided_strips_s1``). One call computes

    out      = ReLU(((conv(concat(x, x_skip) * m) + bias) * ratio) * a + bb)
    ratio    = k^2 / (boxsum_k(m) + 1e-8) * (boxsum_k(m) > 0)
    new_mask = boxsum_k(m) > 0

where ``a, bb`` are the eval BatchNorm folded per channel
(``fold_batch_norm``). The kernel is ``csrc/pconv_eval.cu``; the source
note there gives the design. It has three variants, picked by shape in
``plan_stage``, never as a fallback:

- ``mma``: an implicit GEMM on the tensor cores in 3xTF32 (fp32
  accuracy), for channel counts that are multiples of 4, with split-K
  (``mma_split`` then ``split_reduce``) where the output tiles fill the
  card's SMs badly. It reads the weights as ``pack_pconv_weight``'s two
  TF32 planes. ``pack_pconv_weights`` packs many weights in one launch:
  ``PConvUNet``'s eval forward packs all its stages in every forward,
  so the planes are never older than the weights (an in-place write
  through ``.data`` moves no version counter a cache could key on); a
  raw call without ``packed`` packs its own.
- ``mma_c1``: one input channel (enc1 at every width, Cout a multiple of
  8 up to 64): persistent blocks over tiles of 8 x 32 outputs
  (``plan_c1``), the patch staged once a tile and split into TF32 planes,
  a separable box-sum, 3xTF32 on the tensor cores in k-steps of 8 taps
  (K = 49 padded to 56). It reads the pack's planes
  (``[Cout][k][k][1]``) and copies nothing of the weight.
- ``simt``: fp32 FMA, for the rest (channel counts that are not
  multiples of 4, beside enc1's).

It takes every stage of the model: k up to 7, stride 1 or 2, outputs
down to 1x1, and the decoder's (up, skip) pair as two inputs read in
place. The plain version is ``ops.pconv.partial_conv2d_split`` (F.conv2d
on x*m, box-sum, renorm) followed by the folded BatchNorm and ReLU.

``fused_pconv_eval`` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. It records no
gradient: on a CUDA tensor under autograd it raises rather than return
a result cut from the graph. ``fused_pconv_eval.launches`` counts stages
(calls), ``fused_pconv_eval.variants`` the CUDA launches of each
variant, ``pack_pconv_weights.launches`` the packs.

The train-mode stage is ``fused_pconv_train`` (``PConvTrain``): the same
kernel and plan with an epilogue that writes the partial conv alone,

    out = (conv(concat(x, x_skip) * m) + bias) * ratio,  new_mask

as ``ops.pconv.partial_conv2d_split`` returns them (its plain version),
for ``nn.BatchNorm2d`` on the batch statistics and the ReLU to follow,
and a backward that is the adjoint autograd takes through the plain
version: cuDNN's dgrad and wgrad. The JAX package has no train-mode
kernel (its train stage is the plain conv); the port runs one because
cuDNN's heuristic forward, with its search off, takes an FFT path of
tens of thousands of small GEMMs a step at some batches, whose launches
the host cannot keep up with. ``fused_pconv_train.launches`` and
``.variants`` count its stages and launches as the eval counters do.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..pconv import partial_conv2d_split, renorm_ratio
from ._build import check, load_library

# the MMA kernel's K-chunk (channels of one tap) and its two tiles (BM, BN)
CHUNK_CHANNELS = 32
MMA_TILES = ((128, 128), (256, 64))
# a split of the K-chunks takes at least this many: fewer would spend
# more on the block's set-up (mask staging, the copy ring's fill) than on MMAs
MIN_CHUNKS_PER_SPLIT = 4
# split while the tiles' last wave is less full than this
WAVE_FILL = 0.9
VARIANTS = ("simt", "mma_c1", "mma", "mma_split", "split_reduce")
# the one-channel variant: output tiles (rows, columns), persistent blocks
# an SM, and the most output channels (csrc/pconv_eval.cu kC1*)
C1_TILE = (8, 32)
C1_BLOCKS_PER_SM = 2
C1_MAX_COUT = 64


class StagePlan(NamedTuple):
    """How one stage runs: the variant, the MMA tile (index into
    MMA_TILES), the split count and the K-chunks the splits share."""

    variant: str
    tile: int
    splits: int
    chunks: int


def wave_fill(blocks: int, sms: int) -> float:
    """Share of the SM slots the grid's waves use, at one block an SM."""
    return blocks / (sms * math.ceil(blocks / sms))


@functools.lru_cache(maxsize=None)
def plan_stage(m: int, n: int, ca: int, cb: int, k: int, sms: int) -> StagePlan:
    """The variant, tile and split count of a stage with M = B*OH*OW
    output pixels, N = Cout, Ca + Cb input channels and a k x k window,
    on a card of ``sms`` SMs. A pure function of the shapes.

    The split count is the least that fills the last wave of blocks to
    WAVE_FILL, or else the one that fills it most, with at least
    MIN_CHUNKS_PER_SPLIT chunks a split. One input channel and Cout a
    multiple of 8 up to C1_MAX_COUT (enc1) take ``mma_c1``; other channel
    counts that are not multiples of 4 take ``simt``."""
    if ca == 1 and cb == 0 and n % 8 == 0 and n <= C1_MAX_COUT:
        return StagePlan("mma_c1", -1, 1, 0)
    if ca % 4 or cb % 4:
        return StagePlan("simt", -1, 1, 0)
    # the 256 x 64 tile's shared memory holds k*k mask taps a row up to k = 5
    tile = 1 if n <= MMA_TILES[1][1] and k <= 5 else 0
    bm, bn = MMA_TILES[tile]
    chunks = k * k * (-(-ca // CHUNK_CHANNELS) + -(-cb // CHUNK_CHANNELS))
    tiles = -(-m // bm) * -(-n // bn)
    best = 1
    for s in range(1, max(1, chunks // MIN_CHUNKS_PER_SPLIT) + 1):
        if wave_fill(tiles * s, sms) > wave_fill(tiles * best, sms):
            best = s
        if wave_fill(tiles * best, sms) >= WAVE_FILL:
            break
    return StagePlan("mma", tile, best, chunks)


class C1Plan(NamedTuple):
    """The one-channel variant's launch: tiles of C1_TILE outputs, walked
    by ``grid`` persistent blocks (block z takes tiles z, z + grid, ...)."""

    tiles_y: int
    tiles_x: int
    tiles: int
    grid: int


@functools.lru_cache(maxsize=None)
def plan_c1(b: int, oh: int, ow: int, sms: int) -> C1Plan:
    """The tiles of a [b, oh, ow] output and the persistent grid that
    walks them: C1_BLOCKS_PER_SM blocks an SM, or one a tile where there
    are fewer tiles. A pure function of the shape."""
    th, tw = C1_TILE
    tiles_y, tiles_x = -(-oh // th), -(-ow // tw)
    tiles = b * tiles_y * tiles_x
    return C1Plan(tiles_y, tiles_x, tiles, min(tiles, sms * C1_BLOCKS_PER_SM))


def c1_tile_origin(plan: C1Plan, t: int) -> Tuple[int, int, int]:
    """Tile t's (batch element, first output row, first output column), as
    the kernel decodes it (c1_tile)."""
    rest, tx = divmod(t, plan.tiles_x)
    b, ty = divmod(rest, plan.tiles_y)
    return b, ty * C1_TILE[0], tx * C1_TILE[1]


def split_chunk_range(z: int, splits: int, chunks: int) -> Tuple[int, int]:
    """The K-chunks [begin, end) of split z, as the kernel computes them."""
    return z * chunks // splits, (z + 1) * chunks // splits


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 to TF32 (10 mantissa bits), to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds, on the fp32 bits; NaN stays NaN."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), x, r)


def pack_pconv_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """nn.Conv2d's [Cout, Cin, k, k] fp32 weight as the MMA kernel's two
    planes (w_hi, w_lo), each [Cout, k, k, Cin] (OHWI, K-major): w_hi is
    w rounded to TF32, w_lo the residual w - w_hi rounded to TF32 (0
    where w_hi is not finite), so w_hi + w_lo is w within 2^-22 of |w|."""
    w = weight.detach().permute(0, 2, 3, 1).contiguous()
    hi = tf32_round(w)
    lo = torch.where(torch.isfinite(hi), tf32_round(w - hi), torch.zeros_like(w))
    return hi, lo


MAX_PACK = 16  # weights one pack launch takes (csrc/pconv_eval.cu kMaxPack)


def pack_pconv_weights(
    weights: Sequence[torch.Tensor],
    out: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``pack_pconv_weight`` of each weight. On the CPU the plain version;
    on a card one launch of ``pack_tf32_kernel`` per MAX_PACK weights,
    bitwise the plain version's planes, each plane its own allocation (the
    allocator's alignment: K2 reads the planes' 128-byte rows whole), or
    written into ``out``, planes this returned before for the same shapes."""
    weights = list(weights)
    if not weights or weights[0].device.type == "cpu":
        return [pack_pconv_weight(w) for w in weights]
    dev = weights[0].device
    if dev.type != "cuda":
        raise ValueError(f"pack_pconv_weights: no kernel for device {dev}")
    for w in weights:
        if w.dim() != 4 or w.device != dev or w.dtype != torch.float32 or not w.is_contiguous():
            raise ValueError(
                "pack_pconv_weights: weights must be contiguous 4-D float32 tensors on "
                f"{dev}, got {tuple(w.shape)} {w.dtype} on {w.device}"
            )
    if out is None:
        out = [tuple(torch.empty((co, k, k, ci), dtype=torch.float32, device=dev)
                     for _ in range(2)) for co, ci, k, _ in (w.shape for w in weights)]
    elif len(out) != len(weights):
        raise ValueError(f"pack_pconv_weights: {len(out)} planes for {len(weights)} weights")
    planes = out
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for s in range(0, len(weights), MAX_PACK):
            group = list(zip(weights, planes))[s : s + MAX_PACK]
            n = len(group)
            ptrs = lambda ts: (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))  # noqa: E731
            ints = lambda vs: (ctypes.c_int * n)(*vs)  # noqa: E731
            check(lib.tg_pack_tf32_planes(
                ptrs(w for w, _ in group), ptrs(p[0] for _, p in group),
                ptrs(p[1] for _, p in group), ints(w.shape[0] for w, _ in group),
                ints(w.shape[1] for w, _ in group), ints(w.shape[2] for w, _ in group),
                n, stream,
            ), "pack_pconv_weights")
            pack_pconv_weights.launches += 1
    return planes


pack_pconv_weights.launches = 0


def fold_batch_norm(
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as y * a + bb (pconv_kernel.py:222-229)."""
    a = weight / torch.sqrt(running_var + eps)
    return a, bias - running_mean * a


def fused_pconv_train_plain(
    x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    stride: int,
    padding: int,
    x_skip: Optional[torch.Tensor] = None,
    packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train-mode stage's partial conv in plain PyTorch, under autograd;
    same arguments as ``fused_pconv_train`` (``packed`` is not read)."""
    parts = (x,) if x_skip is None else (x, x_skip)
    kernel = weight.permute(2, 3, 1, 0)  # HWIO, the layout of ops.pconv
    return partial_conv2d_split(parts, mask, kernel, bias, stride, padding)


def fused_pconv_eval_plain(
    x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    stride: int,
    padding: int,
    bn_a: torch.Tensor,
    bn_b: torch.Tensor,
    x_skip: Optional[torch.Tensor] = None,
    packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stage in plain PyTorch; same arguments as ``fused_pconv_eval``
    (``packed`` is the kernel's and is not read)."""
    out, new_mask = fused_pconv_train_plain(x, mask, weight, bias, stride, padding, x_skip)
    return torch.relu(out * bn_a + bn_b), new_mask


def _check_cuda_args(entry, x, x_skip, mask, weight, vecs, stride, padding):
    """Raise on what the kernel does not take; it reads raw pointers."""
    b, h, w, ca = x.shape
    cb = 0 if x_skip is None else x_skip.shape[-1]
    cout, k = weight.shape[0], weight.shape[-1]
    expect = [("x", x, (b, h, w, ca)), ("mask", mask, (b, h, w, 1)),
              ("weight", weight, (cout, ca + cb, k, k))]
    if x_skip is not None:
        expect.append(("x_skip", x_skip, (b, h, w, cb)))
    expect += [(name, v, (cout,)) for name, v in zip(("bias", "bn_a", "bn_b"), vecs)]
    _check_tensors(entry, x.device, expect)
    if not (1 <= k <= 7 and stride in (1, 2) and 0 <= padding and cout % 4 == 0):
        raise ValueError(
            f"{entry}: k={k} stride={stride} padding={padding} cout={cout} "
            "outside the kernel (k <= 7, stride 1 or 2, cout % 4 == 0)"
        )
    if b > 65535:
        raise ValueError(f"{entry}: batch {b} above 65535")
    if b * h * w >= 2**31:
        raise ValueError(f"{entry}: {b}x{h}x{w} pixels index past 2^31")


def _check_tensors(entry, device, expect):
    for name, t, shape in expect:
        if tuple(t.shape) != shape:
            raise ValueError(f"{entry}: {name} has shape {tuple(t.shape)}, needs {shape}")
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{entry}: {name} must be a contiguous float32 tensor on "
                f"{device}, got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{entry}: {name} is not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count, which plan_stage sizes the splits by."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_pconv_eval(
    x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    stride: int,
    padding: int,
    bn_a: torch.Tensor,
    bn_b: torch.Tensor,
    x_skip: Optional[torch.Tensor] = None,
    packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One eval PConv stage, NHWC.

    x: [B,H,W,Ca]; x_skip: optional [B,H,W,Cb], the second half of an
    implicit channel concat; mask: [B,H,W,1]; weight: nn.Conv2d's own
    [Cout,Ca+Cb,k,k]; bias, bn_a, bn_b: [Cout]; packed: optional
    ``pack_pconv_weight(weight)``, else the MMA variants pack per call.
    Returns (out [B,OH,OW,Cout], new_mask [B,OH,OW,1]), both fp32.
    """
    if x.device.type == "cpu":
        return fused_pconv_eval_plain(
            x, mask, weight, bias, stride, padding, bn_a, bn_b, x_skip
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_pconv_eval: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, x_skip, weight, bias, bn_a, bn_b)
    ):
        raise RuntimeError(
            "fused_pconv_eval: the kernel records no gradient; run the eval "
            "forward under torch.no_grad() or the stage in train mode"
        )
    return _launch_stage(fused_pconv_eval, x, mask, weight, bias, stride, padding, (bn_a, bn_b),
                         x_skip, packed)


def _launch_stage(wrapper, x, mask, weight, bias, stride, padding, bn, x_skip, packed):
    """One stage on K2 into new tensors: the eval forward's epilogue with
    ``bn`` = (bn_a, bn_b), the train forward's with None. Counts the stage
    in ``wrapper.launches`` and its CUDA launches in ``wrapper.variants``."""
    entry = wrapper.__name__
    train = bn is None
    bn_a, bn_b = (None, None) if train else bn
    _check_cuda_args(entry, x, x_skip, mask, weight, (bias,) if train else (bias, bn_a, bn_b),
                     stride, padding)
    b, h, w, ca = x.shape
    cb = 0 if x_skip is None else x_skip.shape[-1]
    cout, k = weight.shape[0], weight.shape[-1]
    oh = (h + 2 * padding - k) // stride + 1
    ow = (w + 2 * padding - k) // stride + 1
    if oh < 1 or ow < 1 or b * oh * ow >= 2**31:
        raise ValueError(f"{entry}: output {b}x{oh}x{ow} empty or past 2^31 pixels")
    plan = plan_stage(b * oh * ow, cout, ca, cb, k, sm_count(x.device))
    out = torch.empty((b, oh, ow, cout), dtype=torch.float32, device=x.device)
    new_mask = torch.empty((b, oh, ow, 1), dtype=torch.float32, device=x.device)
    skip_ptr = None if x_skip is None else x_skip.data_ptr()
    a_ptr = None if train else bn_a.data_ptr()
    b_ptr = None if train else bn_b.data_ptr()
    lib = load_library()
    variants = wrapper.variants
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.variant == "simt":
            # reads HWIO, Cout innermost, as float4 runs of 4 channels
            kernel = weight.permute(2, 3, 1, 0).contiguous()
            err = lib.tg_pconv_eval_f32(
                x.data_ptr(), skip_ptr, mask.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
                a_ptr, b_ptr, out.data_ptr(), new_mask.data_ptr(),
                b, h, w, ca, cb, cout, k, stride, padding, train, stream,
            )
            check(err, entry)
            variants["simt"] += 1
        elif plan.variant == "mma_c1":
            if packed is None:
                packed = pack_pconv_weights([weight])[0]
            w_hi, w_lo = packed
            _check_tensors(entry, x.device, [(name, p, (cout, k, k, 1))
                                             for name, p in (("w_hi", w_hi), ("w_lo", w_lo))])
            c1 = plan_c1(b, oh, ow, sm_count(x.device))
            err = lib.tg_pconv_eval_c1_f32(
                x.data_ptr(), mask.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
                bias.data_ptr(), a_ptr, b_ptr, out.data_ptr(),
                new_mask.data_ptr(), b, h, w, cout, k, stride, padding, c1.grid, train, stream,
            )
            check(err, entry)
            variants["mma_c1"] += 1
        else:
            if packed is None:
                packed = pack_pconv_weights([weight])[0]
            w_hi, w_lo = packed
            _check_tensors(entry, x.device, [(name, p, (cout, k, k, ca + cb))
                                             for name, p in (("w_hi", w_hi), ("w_lo", w_lo))])
            ws = ratio_ws = None
            if plan.splits > 1:
                ws = torch.empty((plan.splits, b * oh * ow, cout), dtype=torch.float32,
                                 device=x.device)
                ratio_ws = torch.empty(b * oh * ow, dtype=torch.float32, device=x.device)
            err = lib.tg_pconv_eval_mma_f32(
                x.data_ptr(), skip_ptr, mask.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
                bias.data_ptr(), a_ptr, b_ptr, out.data_ptr(),
                new_mask.data_ptr(), None if ws is None else ws.data_ptr(),
                None if ratio_ws is None else ratio_ws.data_ptr(),
                b, h, w, ca, cb, cout, k, stride, padding, plan.tile, plan.splits, train, stream,
            )
            check(err, entry)
            if plan.splits > 1:
                variants["mma_split"] += 1
                variants["split_reduce"] += 1
            else:
                variants["mma"] += 1
    wrapper.launches += 1
    return out, new_mask


fused_pconv_eval.launches = 0
fused_pconv_eval.variants = dict.fromkeys(VARIANTS, 0)


class PConvTrain(torch.autograd.Function):
    """A train-mode PConv stage: (out, new_mask) as ``partial_conv2d_split``
    returns them, with the adjoint autograd takes through that as its
    backward.

    Forward: K2's train variant on a card (counted in ``fused_pconv_train``),
    the plain version on the CPU. Backward, with g = grad_out * ratio (the
    ratio is data: no gradient flows through it): grad_bias = the sum of g,
    and for each part p of the implicit concat ``convolution_backward``
    (cuDNN's dgrad and wgrad on a card) of g against p * m and the part's
    slice of the weight, then grad_p = grad_(p * m) * m. It saves the parts
    and the mask where autograd saved each p * m: the same bytes or fewer,
    since a skip and an encoder stage's input are held for their ReLU's
    backward anyway. p * m is formed again for the wgrad and freed before
    the dgrad, and grad_p is written over grad_(p * m).
    """

    @staticmethod
    def forward(ctx, x, x_skip, mask, weight, bias, stride, padding, packed):
        if x.device.type == "cpu":
            out, new_mask = fused_pconv_train_plain(x, mask, weight, bias, stride, padding, x_skip)
        else:
            out, new_mask = _launch_stage(fused_pconv_train, x, mask, weight, bias, stride,
                                          padding, None, x_skip, packed)
        ctx.save_for_backward(x, x_skip, mask, weight)
        ctx.stride, ctx.padding = stride, padding
        ctx.mark_non_differentiable(new_mask)
        ctx.set_materialize_grads(False)  # new_mask's gradient (None) is never built
        return out, new_mask

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out, _):
        if grad_out is None:  # an undefined gradient (gradcheck passes one)
            return (None,) * 8
        x, x_skip, mask, weight = ctx.saved_tensors
        need_x, need_skip, _, need_w, need_b = ctx.needs_input_grad[:5]
        stride, padding, k = ctx.stride, ctx.padding, weight.shape[-1]
        ratio, _ = renorm_ratio(mask, k, k, stride, padding)
        g = grad_out * ratio
        g_nchw, m = g.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2)
        conv = ([stride] * 2, [padding] * 2, [1, 1], False, [0, 0], 1)
        grads, grad_ws, offset = [], [], 0
        for part, need in ((x, need_x), (x_skip, need_skip)):
            if part is None:
                grads.append(None)
                continue
            w = weight[:, offset : offset + part.shape[-1]]
            offset += part.shape[-1]
            p_nchw = part.permute(0, 3, 1, 2)
            if need_w:  # wgrad, then x*m is freed
                grad_ws.append(torch.ops.aten.convolution_backward(
                    g_nchw, p_nchw * m, w, None, *conv, [False, True, False])[1])
            grad_p = None
            if need:  # dgrad reads its input's shape and layout alone: the part's view will do
                grad_p = torch.ops.aten.convolution_backward(
                    g_nchw, p_nchw, w, None, *conv, [True, False, False])[0]
                grad_p = grad_p.mul_(m).permute(0, 2, 3, 1)
            grads.append(grad_p)
        grad_w = (grad_ws[0] if len(grad_ws) == 1 else torch.cat(grad_ws, 1)) if need_w else None
        grad_b = g.sum((0, 1, 2)) if need_b else None
        return grads[0], grads[1], None, grad_w, grad_b, None, None, None


def fused_pconv_train(
    x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    stride: int,
    padding: int,
    x_skip: Optional[torch.Tensor] = None,
    packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One train-mode PConv stage, NHWC, before its BatchNorm and ReLU:
    ``partial_conv2d_split``'s (out, new_mask) of the implicit concat
    (x, x_skip) under autograd (``PConvTrain``). Arguments as
    ``fused_pconv_eval``'s without the folded BatchNorm."""
    return PConvTrain.apply(x, x_skip, mask, weight, bias, stride, padding, packed)


fused_pconv_train.launches = 0
fused_pconv_train.variants = dict.fromkeys(VARIANTS, 0)
# the train-mode stage of each eval stage, which a train-mode PConv2d takes
fused_pconv_eval.train = fused_pconv_train
fused_pconv_eval_plain.train = fused_pconv_train_plain
