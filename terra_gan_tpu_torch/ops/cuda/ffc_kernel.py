"""A block FFC's local and cross convolutions: CUDA kernels and their plain versions.

One call computes, for Big-LaMa's block FFC (``models/lama.py``; NCHW,
3x3 convolutions without bias at stride 1 with reflect padding 1),

    y_l = conv(x_l, w_l2l) + conv(x_g, w_g2l)
    y_g = conv(x_l, w_l2g) + s

where ``s`` is the spectral transform's output. The kernel is
``csrc/ffc_conv.cu``: both outputs in one launch, a 3xTF32 implicit GEMM
on the tensor cores (fp32 accuracy) that reads the reflect padding in
its own tile loads, takes the channel concat [x_l; x_g] in place and
sums the two convolutions of y_l in its accumulator; the source note
there gives the design. It reads the weights as ``pack_pconv_weights``'
TF32 planes, packed in one launch at every call, so they are never older
than the weights. The JAX package has no Big-LaMa, so the kernel
replaces no TPU kernel: it exists because cuDNN's heuristic, with its
search off, takes its fp32 FFT path for l2g and g2l and fp32 off the
tensor cores for l2l.

The plain version pads each input once (``F.pad``, reflect) and runs
``F.conv2d`` three times, then the sums: the bits of three
``nn.Conv2d(padding_mode="reflect")`` and the two sums.

``ffc_local`` is differentiable (``FFCLocal``). On a card its forward is
the kernel and its backward two more kernels of the same file:
``ffc_local_dgrad``, the input gradients (the forward's body on the
gradients with the weights rotated and transposed, zero padding, and
the reflect pad's adjoint folded in), and ``ffc_local_wgrad``, the
weight gradients (3xTF32 over the pixels, split over the SMs by
``plan_wgrad``, the splits added in a fixed order: the gradients repeat
bit for bit); ``grad_s = grad_y_g``. Their plain versions,
``ffc_local_dgrad_plain`` and ``ffc_local_wgrad_plain``, follow the
kernels' arithmetic in plain PyTorch. A CUDA tensor never reaches a
plain version, and one the kernels do not take raises. On the CPU the
forward is the plain version and the backward ``ffc_local_backward_plain``,
the adjoint autograd takes through it: for each convolution one
``convolution_backward`` against the reflect-padded input, formed again
and freed, then the pad's backward. ``ffc_local.launches``,
``ffc_local_dgrad.launches`` and ``ffc_local_wgrad.launches`` count the
calls of each kernel (one a call).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ...utils.trace import span
from ._build import check, load_library
from .pconv_kernel import _check_tensors, pack_pconv_weights, sm_count

PAD = (1, 1, 1, 1)
# the conv arguments of convolution_backward after the padded input:
# stride, padding, dilation, transposed, output padding, groups
_CONV = ([1, 1], [0, 0], [1, 1], False, [0, 0], 1)
# ffc_wgrad_kernel's job (output channels, input channels, each with its 9
# taps) and pixels a stage (kWBM, kWBC, kWPix in csrc/ffc_conv.cu; chip_smoke.py
# reads them back through tg_ffc_wgrad_info), and a job's sums a split
WGRAD_TILE = (128, 16)
WGRAD_PIXELS = 64
WGRAD_TILE_SUMS = 9 * 2 * 4 * 256
# a block's stages outside its K loop (the ring's fill, the partial sums'
# write), as plan_wgrad weighs a split against its cost
WGRAD_FILL = 2
MAX_WGRAD_SPLITS = 32


def ffc_local_plain(x_l, x_g, s, w_l2l, w_g2l, w_l2g) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y_l, y_g) in plain PyTorch, under autograd; arguments as ``ffc_local``'s."""
    p_l = F.pad(x_l, PAD, mode="reflect")
    p_g = F.pad(x_g, PAD, mode="reflect")
    return F.conv2d(p_l, w_l2l) + F.conv2d(p_g, w_g2l), F.conv2d(p_l, w_l2g) + s


def rot(w: torch.Tensor) -> torch.Tensor:
    """A 3x3 weight [N][C][3][3] as the adjoint convolution's: [C][N][3][3],
    both taps flipped."""
    return w.transpose(0, 1).flip(2, 3)


def reflect_fold(d: torch.Tensor) -> torch.Tensor:
    """The reflect pad's adjoint: [B][C][H+2][W+2] to [B][C][H][W], padded
    row 0 added onto row 1 and row H+1 onto row H-2, then the same for the
    columns (the corners both ways)."""
    h, w = d.shape[2] - 2, d.shape[3] - 2
    rows = d[:, :, 1:h + 1].clone()
    rows[:, :, 1] += d[:, :, 0]
    rows[:, :, h - 2] += d[:, :, h + 1]
    out = rows[..., 1:w + 1].clone()
    out[..., 1] += rows[..., 0]
    out[..., w - 2] += rows[..., w + 1]
    return out


def ffc_local_dgrad_plain(grad_l, grad_g, w_l2l, w_g2l, w_l2g) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad x_l, grad x_g) of ``ffc_local`` from grad y_l, grad y_g, as the
    dgrad kernel computes them: the gradients of the padded inputs, convolutions
    of the gradients zero-padded by 2 with the rotated weights, then the
    reflect pad's adjoint."""
    pad = lambda g: F.pad(g, (2, 2, 2, 2))  # noqa: E731
    d_l = F.conv2d(pad(grad_l), rot(w_l2l)) + F.conv2d(pad(grad_g), rot(w_l2g))
    return reflect_fold(d_l), reflect_fold(F.conv2d(pad(grad_l), rot(w_g2l)))


def ffc_local_wgrad_plain(x_l, x_g, grad_l, grad_g) -> Tuple[torch.Tensor, ...]:
    """(grad w_l2l, grad w_g2l, grad w_l2g) of ``ffc_local``, as the wgrad
    kernel computes them: at each tap (ky, kx), the gradient's channels
    times the reflect-padded input's at that shift, summed over the batch's
    pixels."""
    def wgrad(g, x):
        b, n, h, w = g.shape
        p = F.pad(x, PAD, mode="reflect")
        gm = g.transpose(0, 1).reshape(n, -1)
        taps = [gm @ p[:, :, ky:ky + h, kx:kx + w].transpose(0, 1).reshape(x.shape[1], -1).T
                for ky in range(3) for kx in range(3)]
        return torch.stack(taps, -1).view(n, x.shape[1], 3, 3)

    return wgrad(grad_l, x_l), wgrad(grad_l, x_g), wgrad(grad_g, x_l)


def ffc_local_backward_plain(x_l, x_g, w_l2l, w_g2l, w_l2g, grad_l, grad_g, need=(True,) * 5):
    """(grad x_l, x_g, w_l2l, w_g2l, w_l2g), each None where ``need`` (in
    that order) says so: the adjoint autograd takes through
    ``ffc_local_plain``, its bits on the CPU. One ``convolution_backward``
    a convolution (cuDNN's dgrad and wgrad on a card) against the
    reflect-padded input, formed again and freed, then the pad's backward."""
    need_xl, need_xg, need_ll, need_gl, need_lg = need
    conv_backward = torch.ops.aten.convolution_backward
    grad_x_l = grad_x_g = g_ll = g_gl = g_lg = None
    if need_xl or need_ll or need_lg:
        p_l = F.pad(x_l, PAD, mode="reflect")
        d_ll, g_ll, _ = conv_backward(grad_l, p_l, w_l2l, None, *_CONV,
                                      [need_xl, need_ll, False])
        d_lg, g_lg, _ = conv_backward(grad_g, p_l, w_l2g, None, *_CONV,
                                      [need_xl, need_lg, False])
        del p_l
        if need_xl:
            grad_x_l = torch.ops.aten.reflection_pad2d_backward(d_ll.add_(d_lg), x_l, list(PAD))
    if need_xg or need_gl:
        d_gl, g_gl, _ = conv_backward(grad_l, F.pad(x_g, PAD, mode="reflect"), w_g2l, None,
                                      *_CONV, [need_xg, need_gl, False])
        if need_xg:
            grad_x_g = torch.ops.aten.reflection_pad2d_backward(d_gl, x_g, list(PAD))
    return grad_x_l, grad_x_g, g_ll, g_gl, g_lg


def plan_wgrad(b: int, h: int, w: int, ca: int, cb: int, nl: int, ng: int, need, sms: int):
    """(jobs, splits, stages) of ``ffc_local_wgrad``: the jobs of the
    products ``need`` asks for (l2l, g2l, l2g), the stages (a row segment of
    WGRAD_PIXELS pixels of one image) and the splits the stages are cut
    into, the count that finishes soonest: one block an SM, so the waves
    (jobs x splits over the SMs) times the stages of a split, each block
    WGRAD_FILL stages more; the fewer splits where two tie."""
    bm, bc = WGRAD_TILE
    ct = lambda c: -(-c // bc)  # noqa: E731
    mt = lambda n: -(-n // bm)  # noqa: E731
    jobs = (mt(nl) * ct(ca) * bool(need[0]) + mt(nl) * ct(cb) * bool(need[1])
            + mt(ng) * ct(ca) * bool(need[2]))
    stages = b * h * -(-w // WGRAD_PIXELS)
    cost = lambda s: -(-jobs * s // sms) * (-(-stages // s) + WGRAD_FILL)  # noqa: E731
    splits = min(range(1, min(stages, MAX_WGRAD_SPLITS) + 1), key=lambda s: (cost(s), s))
    return jobs, splits, stages


def check_args(x_l, x_g, s, w_l2l, w_g2l, w_l2g) -> None:
    """Raise on what the kernel does not take: it reads raw pointers."""
    if x_l.dim() != 4 or x_g.dim() != 4:
        raise ValueError(f"ffc_local: x_l {tuple(x_l.shape)} and x_g {tuple(x_g.shape)} not NCHW")
    b, ca, h, w = x_l.shape
    cb, nl, ng = x_g.shape[1], w_l2l.shape[0], w_l2g.shape[0]
    _check_tensors("ffc_local", x_l.device, [
        ("x_l", x_l, (b, ca, h, w)), ("x_g", x_g, (b, cb, h, w)), ("s", s, (b, ng, h, w)),
        ("w_l2l", w_l2l, (nl, ca, 3, 3)), ("w_g2l", w_g2l, (nl, cb, 3, 3)),
        ("w_l2g", w_l2g, (ng, ca, 3, 3))])
    if ca % 4 or cb % 4 or h < 2 or w < 2:
        raise ValueError(f"ffc_local: {ca} local and {cb} global channels at {h}x{w}; the kernel "
                         "takes channel counts that are multiples of 4 and sides of 2 or more")
    if b * -(-h // 2) * -(-w // 64) >= 2**31 or -(-nl // 128) + -(-ng // 128) > 65535:
        raise ValueError(f"ffc_local: {b}x{h}x{w} pixels, {nl} + {ng} outputs: past the grid")


def ffc_local_kernel(x_l, x_g, s, w_l2l, w_g2l, w_l2g):
    """The kernel alone, no autograd, into new tensors; raises on what it
    does not take."""
    if x_l.device.type != "cuda":
        raise ValueError(f"ffc_local: no kernel for device {x_l.device}")
    check_args(x_l, x_g, s, w_l2l, w_g2l, w_l2g)
    b, ca, h, w = x_l.shape
    cb, nl, ng = x_g.shape[1], w_l2l.shape[0], w_l2g.shape[0]
    (ll_hi, ll_lo), (gl_hi, gl_lo), (lg_hi, lg_lo) = pack_pconv_weights([w_l2l, w_g2l, w_l2g])
    new = lambda c: torch.empty((b, c, h, w), dtype=torch.float32, device=x_l.device)  # noqa: E731
    y_l, y_g = new(nl), new(ng)
    lib = load_library()
    with torch.cuda.device(x_l.device):
        check(lib.tg_ffc_local_f32(
            x_l.data_ptr(), x_g.data_ptr(), s.data_ptr(), ll_hi.data_ptr(), ll_lo.data_ptr(),
            gl_hi.data_ptr(), gl_lo.data_ptr(), lg_hi.data_ptr(), lg_lo.data_ptr(),
            y_l.data_ptr(), y_g.data_ptr(), b, h, w, ca, cb, nl, ng,
            torch.cuda.current_stream().cuda_stream,
        ), "ffc_local")
    ffc_local.launches += 1
    return y_l, y_g


def check_backward(grad_l, grad_g, w_l2l, w_g2l, w_l2g) -> None:
    """Raise on what the backward's kernels do not take, beyond what the
    forward's check took: their gradients' channel counts (the dgrad's
    inputs) are multiples of 4 too."""
    b, nl, h, w = grad_l.shape
    ng, ca, cb = w_l2g.shape[0], w_l2l.shape[1], w_g2l.shape[1]
    _check_tensors("ffc_local backward", grad_l.device, [
        ("grad_l", grad_l, (b, nl, h, w)), ("grad_g", grad_g, (b, ng, h, w)),
        ("w_l2l", w_l2l, (nl, ca, 3, 3)), ("w_g2l", w_g2l, (nl, cb, 3, 3)),
        ("w_l2g", w_l2g, (ng, ca, 3, 3))])
    if nl % 4 or ng % 4 or h < 2 or w < 2:
        raise ValueError(f"ffc_local backward: {nl} local and {ng} global outputs at {h}x{w}; "
                         "the kernels take output counts that are multiples of 4")


def ffc_local_dgrad(grad_l, grad_g, w_l2l, w_g2l, w_l2g, need=(True, True)):
    """(grad x_l, grad x_g) on a card, each None where ``need`` says so; the
    kernels alone, no autograd, into new tensors; raises on what they do
    not take. One pack of the rotated weights' planes, the frame and border
    kernels, the main kernel, then the fold."""
    if grad_l.device.type != "cuda":
        raise ValueError(f"ffc_local_dgrad: no kernel for device {grad_l.device}")
    check_backward(grad_l, grad_g, w_l2l, w_g2l, w_l2g)
    b, nl, h, w = grad_l.shape
    ng, ca, cb = grad_g.shape[1], w_l2l.shape[1], w_g2l.shape[1]
    dev = grad_l.device
    (ll_hi, ll_lo), (lg_hi, lg_lo), (gl_hi, gl_lo) = pack_pconv_weights(
        [rot(v).contiguous() for v in (w_l2l, w_l2g, w_g2l)])
    lib = load_library()  # the scratch: the border's values and g's frame, laid out there
    scratch = torch.empty((lib.tg_ffc_dgrad_scratch(b, h, w, ca, cb, nl, ng),),
                          dtype=torch.float32, device=dev)
    new = lambda c, on: (torch.empty((b, c, h, w), dtype=torch.float32, device=dev)  # noqa: E731
                         if on else None)
    dx_l, dx_g = new(ca, need[0]), new(cb, need[1])
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(dev):
        check(lib.tg_ffc_dgrad_f32(
            grad_l.data_ptr(), grad_g.data_ptr(), w_l2l.data_ptr(), w_l2g.data_ptr(),
            w_g2l.data_ptr(), ll_hi.data_ptr(), ll_lo.data_ptr(), lg_hi.data_ptr(),
            lg_lo.data_ptr(), gl_hi.data_ptr(), gl_lo.data_ptr(), scratch.data_ptr(), ptr(dx_l),
            ptr(dx_g), b, h, w, ca, cb, nl, ng, bool(need[0]) | 2 * bool(need[1]),
            torch.cuda.current_stream().cuda_stream,
        ), "ffc_local_dgrad")
    ffc_local_dgrad.launches += 1
    return dx_l, dx_g


ffc_local_dgrad.launches = 0


def ffc_local_wgrad(x_l, x_g, grad_l, grad_g, need=(True, True, True)):
    """(grad w_l2l, grad w_g2l, grad w_l2g) on a card, each None where
    ``need`` says so; the kernels alone, no autograd, into new tensors;
    raises on what they do not take. The wgrad kernel over
    ``plan_wgrad``'s splits, then their sums added in a fixed order."""
    if x_l.device.type != "cuda":
        raise ValueError(f"ffc_local_wgrad: no kernel for device {x_l.device}")
    b, ca, h, w = x_l.shape
    cb, nl, ng = x_g.shape[1], grad_l.shape[1], grad_g.shape[1]
    _check_tensors("ffc_local_wgrad", x_l.device, [
        ("x_l", x_l, (b, ca, h, w)), ("x_g", x_g, (b, cb, h, w)),
        ("grad_l", grad_l, (b, nl, h, w)), ("grad_g", grad_g, (b, ng, h, w))])
    if h < 2 or w < 2:
        raise ValueError(f"ffc_local_wgrad: {h}x{w}; the reflect padding takes sides of 2 or more")
    dev = x_l.device
    jobs, splits, _ = plan_wgrad(b, h, w, ca, cb, nl, ng, need, sm_count(dev))
    part = torch.empty((max(jobs, 1) * splits * WGRAD_TILE_SUMS,), dtype=torch.float32,
                       device=dev)
    shapes = ((nl, ca, 3, 3), (nl, cb, 3, 3), (ng, ca, 3, 3))
    outs = [torch.empty(sh, dtype=torch.float32, device=dev) if on else None
            for sh, on in zip(shapes, need)]
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = load_library()
    with torch.cuda.device(dev):
        check(lib.tg_ffc_wgrad_f32(
            x_l.data_ptr(), x_g.data_ptr(), grad_l.data_ptr(), grad_g.data_ptr(),
            part.data_ptr(), *(ptr(o) for o in outs), b, h, w, ca, cb, nl, ng,
            sum(bool(n) << i for i, n in enumerate(need)), splits,
            torch.cuda.current_stream().cuda_stream,
        ), "ffc_local_wgrad")
    ffc_local_wgrad.launches += 1
    return tuple(outs)


ffc_local_wgrad.launches = 0


class FFCLocal(torch.autograd.Function):
    """(y_l, y_g) of a block FFC's local and cross convolutions; on a card
    the kernels both ways, on the CPU the plain version and the adjoint
    autograd takes through it (``ffc_local_backward_plain``).

    Saves x_l, x_g and the three weights, where autograd saved the three
    padded copies. The backward runs inside a ``tg.ffc_local_bwd`` range
    (``utils/trace.py``: a range only under a profiler)."""

    @staticmethod
    def forward(ctx, x_l, x_g, s, w_l2l, w_g2l, w_l2g):
        plain = x_l.device.type == "cpu"
        y_l, y_g = (ffc_local_plain if plain else ffc_local_kernel)(x_l, x_g, s, w_l2l, w_g2l,
                                                                    w_l2g)
        ctx.save_for_backward(x_l, x_g, w_l2l, w_g2l, w_l2g)
        return y_l, y_g

    @staticmethod
    def backward(ctx, grad_l, grad_g):
        x_l, x_g, w_l2l, w_g2l, w_l2g = ctx.saved_tensors
        need_xl, need_xg, need_s, need_ll, need_gl, need_lg = ctx.needs_input_grad
        with span("tg.ffc_local_bwd"):
            if x_l.device.type == "cpu":
                grad_x_l, grad_x_g, g_ll, g_gl, g_lg = ffc_local_backward_plain(
                    x_l, x_g, w_l2l, w_g2l, w_l2g, grad_l, grad_g,
                    (need_xl, need_xg, need_ll, need_gl, need_lg))
            else:
                g_l, g_g = grad_l.contiguous(), grad_g.contiguous()
                grad_x_l = grad_x_g = g_ll = g_gl = g_lg = None
                if need_xl or need_xg:
                    grad_x_l, grad_x_g = ffc_local_dgrad(g_l, g_g, w_l2l, w_g2l, w_l2g,
                                                         (need_xl, need_xg))
                if need_ll or need_gl or need_lg:
                    g_ll, g_gl, g_lg = ffc_local_wgrad(x_l, x_g, g_l, g_g,
                                                       (need_ll, need_gl, need_lg))
        return grad_x_l, grad_x_g, grad_g if need_s else None, g_ll, g_gl, g_lg


def ffc_local(x_l: torch.Tensor, x_g: torch.Tensor, s: torch.Tensor, w_l2l: torch.Tensor,
              w_g2l: torch.Tensor, w_l2g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A block FFC's (y_l, y_g), NCHW: x_l [B,Ca,H,W], x_g [B,Cb,H,W], s
    [B,Ng,H,W]; the weights nn.Conv2d's own, w_l2l [Nl,Ca,3,3], w_g2l
    [Nl,Cb,3,3], w_l2g [Ng,Ca,3,3]. Differentiable in every argument."""
    return FFCLocal.apply(x_l, x_g, s, w_l2l, w_g2l, w_l2g)


ffc_local.launches = 0
