"""K3: the fused eval-mode decoder tail, CUDA kernel and its plain version.

Replaces terra_gan_tpu/ops/pallas/tail_kernel.py :: fused_decoder_tail
(``_tail_kernel``; its oracle ``tail_reference``). One call computes

    up   = bilinear2x(d)
    m512 = max(nearest2x(dm), xm)
    dec1 = ReLU(((conv([up, x] * m512) + bias) * ratio) * a + bb)
           ratio = 9 / (boxsum3(m512) + 1e-8) * (boxsum3(m512) > 0)
    y    = sigmoid(conv3x3(dec1, k_fin) + b_fin) * (1 - xm) + x * xm

with ``a, bb`` the eval BatchNorm folded per channel. ``k_skip=None``
drops the ``x`` half of the concat: that is the model's own tail, whose
dec1 convolves the upsampled features alone; the JAX function's form
(with ``k_skip``) is kept for the tests that hold the two packages
together. The kernel is ``csrc/decoder_tail.cu``: dec1 as a 3xTF32
implicit GEMM on the tensor cores (fp32 accuracy), bound by its
operations; the source note there gives the design. The plain version
is ``tail_reference``'s op sequence on the port's own ops (K1's and
K2's plain versions, ``F.conv2d``), so on the CPU it gives the bits of
the model's unfused tail, ``PConvUNet.tail_forward``.

``fused_decoder_tail`` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. The kernel has
no backward (the JAX package has none): under autograd on a card it
raises rather than return a result cut from the graph.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..pconv import partial_conv2d_split
from ..resize import upsample2x_nearest
from ._build import check, load_library
from .pconv_kernel import fold_batch_norm
from .upsample_kernel import upsample2x_fwd_plain

MAX_CHANNELS = 64  # the kernel's 8 n-tiles of 8 output channels


def _check_geometry(d: torch.Tensor, x: torch.Tensor) -> None:
    """The JAX guard (tail_kernel.py:254-255): the tail is an exact 2x."""
    h, w = d.shape[1], d.shape[2]
    if x.shape[1] != 2 * h or x.shape[2] != 2 * w:
        raise ValueError(
            f"fused_decoder_tail: needs exact 2x geometry, got d {tuple(d.shape)} "
            f"and x {tuple(x.shape)}"
        )


def fused_decoder_tail_plain(
    d: torch.Tensor,
    dm: torch.Tensor,
    x: torch.Tensor,
    xm: torch.Tensor,
    k_main: torch.Tensor,
    k_skip: Optional[torch.Tensor],
    bias: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    k_fin: torch.Tensor,
    b_fin: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The tail in plain PyTorch; same arguments as ``fused_decoder_tail``."""
    _check_geometry(d, x)
    up = upsample2x_fwd_plain(d)
    m512 = torch.maximum(upsample2x_nearest(dm), xm)
    if k_skip is None:
        out, _ = partial_conv2d_split((up,), m512, k_main, bias, 1, 1)
    else:
        k_cat = torch.cat([k_main, k_skip], dim=2)
        out, _ = partial_conv2d_split((up, x), m512, k_cat, bias, 1, 1)
    a, bb = fold_batch_norm(bn_scale, bn_bias, bn_mean, bn_var, eps)
    h = torch.relu(out * a + bb)
    f = F.conv2d(h.permute(0, 3, 1, 2), k_fin.permute(3, 2, 0, 1), b_fin, padding=1)
    o = torch.sigmoid(f).permute(0, 2, 3, 1)
    return o * (1.0 - xm) + x * xm


def _check_cuda_args(features, weights, c: int) -> None:
    """Raise on what the kernel does not take; it reads raw pointers."""
    dev = features[0][1].device
    for name, t, shape in features + weights:
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_decoder_tail: {name} has shape {tuple(t.shape)}, needs {shape}")
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(
                f"fused_decoder_tail: {name} must be a float32 tensor on {dev}, "
                f"got {t.dtype} on {t.device}"
            )
    for name, t, _ in features:
        if not t.is_contiguous():
            raise ValueError(f"fused_decoder_tail: {name} must be a contiguous NHWC tensor")
    if not (4 <= c <= MAX_CHANNELS and c % 4 == 0):
        raise ValueError(
            f"fused_decoder_tail: C = {c} outside the kernel (a multiple of 4 up to {MAX_CHANNELS})"
        )
    if features[0][1].shape[0] > 65535:
        raise ValueError(f"fused_decoder_tail: batch {features[0][1].shape[0]} above 65535")


def fused_decoder_tail(
    d: torch.Tensor,
    dm: torch.Tensor,
    x: torch.Tensor,
    xm: torch.Tensor,
    k_main: torch.Tensor,
    k_skip: Optional[torch.Tensor],
    bias: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    k_fin: torch.Tensor,
    b_fin: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Fused eval-mode decoder tail, NHWC, fp32. Returns the composite [B,2H,2W,1].

    d: [B,H,W,C] dec2 features; dm: [B,H,W,1] dec2 mask; x / xm:
    [B,2H,2W,1] the input image (already masked) and mask. k_main
    [3,3,C,C], k_skip [3,3,1,C] or None, k_fin [3,3,C,1] (HWIO, the JAX
    layouts); bias and the BatchNorm's scale, bias, mean and var [C];
    b_fin [1]. The weights may be views: the kernel reads packed copies.
    """
    if d.device.type == "cpu":
        return fused_decoder_tail_plain(
            d, dm, x, xm, k_main, k_skip, bias, bn_scale, bn_bias, bn_mean,
            bn_var, k_fin, b_fin, eps,
        )
    if d.device.type != "cuda":
        raise ValueError(f"fused_decoder_tail: no kernel for device {d.device}")
    params = (k_main, k_skip, bias, bn_scale, bn_bias, bn_mean, bn_var, k_fin, b_fin)
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (d, dm, x, xm, *params)
    ):
        raise RuntimeError(
            "fused_decoder_tail: the kernel records no gradient; run the eval "
            "forward under torch.no_grad() (K3 is eval-only)"
        )
    _check_geometry(d, x)
    b, h, w, c = d.shape
    big = (b, 2 * h, 2 * w, 1)
    features = [("d", d, (b, h, w, c)), ("dm", dm, (b, h, w, 1)), ("x", x, big), ("xm", xm, big)]
    weights = [("k_main", k_main, (3, 3, c, c)), ("k_skip", k_skip, (3, 3, 1, c)),
               ("k_fin", k_fin, (3, 3, c, 1)), ("b_fin", b_fin, (1,))]
    weights += [(n, v, (c,)) for n, v in
                zip(("bias", "bn_scale", "bn_bias", "bn_mean", "bn_var"), params[2:7])]
    _check_cuda_args(features, weights, c)
    y = torch.empty(big, dtype=torch.float32, device=d.device)
    if b == 0:
        return y
    a, bb = fold_batch_norm(bn_scale, bn_bias, bn_mean, bn_var, eps)
    k_main, k_fin, bias = k_main.contiguous(), k_fin.contiguous(), bias.contiguous()
    k_skip = None if k_skip is None else k_skip.contiguous()
    for name, t in (("d", d), ("k_main", k_main), ("k_skip", k_skip), ("bias", bias),
                    ("bn_a", a), ("bn_b", bb)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"fused_decoder_tail: {name} is not 16-byte aligned")
    lib = load_library()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(
            lib.tg_decoder_tail_f32(
                d.data_ptr(), dm.data_ptr(), x.data_ptr(), xm.data_ptr(),
                k_main.data_ptr(), None if k_skip is None else k_skip.data_ptr(),
                bias.data_ptr(), a.data_ptr(), bb.data_ptr(), k_fin.data_ptr(),
                b_fin.data_ptr(), y.data_ptr(), b, h, w, c, stream,
            ),
            "fused_decoder_tail",
        )
    fused_decoder_tail.launches += 1
    return y


fused_decoder_tail.launches = 0
