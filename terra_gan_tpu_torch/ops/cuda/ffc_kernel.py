"""A block FFC's local and cross convolutions: CUDA kernel and its plain version.

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

``ffc_local`` is differentiable (``FFCLocal``): its forward is the
kernel on a card and the plain version on the CPU; a CUDA tensor never
reaches the plain version, and one the kernel does not take raises. Its
backward is the one autograd takes through the plain version: for each
convolution one ``convolution_backward`` (cuDNN's dgrad and wgrad on a
card) against the reflect-padded input, formed again and freed, then the
pad's backward, and ``grad_s = grad_y_g``. ``ffc_local.launches``
counts the kernel's launches (one a call).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ._build import check, load_library
from .pconv_kernel import _check_tensors, pack_pconv_weights

PAD = (1, 1, 1, 1)
# the conv arguments of convolution_backward after the padded input:
# stride, padding, dilation, transposed, output padding, groups
_CONV = ([1, 1], [0, 0], [1, 1], False, [0, 0], 1)


def ffc_local_plain(x_l, x_g, s, w_l2l, w_g2l, w_l2g) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y_l, y_g) in plain PyTorch, under autograd; arguments as ``ffc_local``'s."""
    p_l = F.pad(x_l, PAD, mode="reflect")
    p_g = F.pad(x_g, PAD, mode="reflect")
    return F.conv2d(p_l, w_l2l) + F.conv2d(p_g, w_g2l), F.conv2d(p_l, w_l2g) + s


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


class FFCLocal(torch.autograd.Function):
    """(y_l, y_g) of a block FFC's local and cross convolutions, with the
    adjoint autograd takes through ``ffc_local_plain`` as its backward.

    Saves x_l, x_g and the three weights, where autograd saved the three
    padded copies; the backward forms each padded input again for its
    convolutions' wgrad (dgrad reads its shape alone) and frees it."""

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
                grad_x_l = torch.ops.aten.reflection_pad2d_backward(d_ll.add_(d_lg), x_l,
                                                                    list(PAD))
        if need_xg or need_gl:
            d_gl, g_gl, _ = conv_backward(grad_l, F.pad(x_g, PAD, mode="reflect"), w_g2l, None,
                                          *_CONV, [need_xg, need_gl, False])
            if need_xg:
                grad_x_g = torch.ops.aten.reflection_pad2d_backward(d_gl, x_g, list(PAD))
        return grad_x_l, grad_x_g, grad_g if need_s else None, g_ll, g_gl, g_lg


def ffc_local(x_l: torch.Tensor, x_g: torch.Tensor, s: torch.Tensor, w_l2l: torch.Tensor,
              w_g2l: torch.Tensor, w_l2g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A block FFC's (y_l, y_g), NCHW: x_l [B,Ca,H,W], x_g [B,Cb,H,W], s
    [B,Ng,H,W]; the weights nn.Conv2d's own, w_l2l [Nl,Ca,3,3], w_g2l
    [Nl,Cb,3,3], w_l2g [Ng,Ca,3,3]. Differentiable in every argument."""
    return FFCLocal.apply(x_l, x_g, s, w_l2l, w_g2l, w_l2g)


ffc_local.launches = 0
