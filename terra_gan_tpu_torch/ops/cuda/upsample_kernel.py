"""K1: 2x bilinear upsample and its adjoint, CUDA kernels and their plain versions.

Replaces terra_gan_tpu/ops/pallas/upsample_kernel.py ::
upsample2x_fwd_pallas (``_up_fwd``, body ``_fwd_kernel``) and
upsample2x_bwd_pallas (``_up_bwd``, body ``_bwd_kernel``). The kernels
are ``csrc/upsample2x.cu``: NHWC, fp32 and bf16 storage with fp32 taps,
16-byte accesses (C a multiple of 4 in fp32, of 8 in bf16), bound by
device-memory bytes (one read, one write); the source note there gives
the design. The forward evaluates torch's own expression for the taps,
so on a card its fp32 result is torch's to the bit. The plain versions are torch's own
``F.interpolate(..., mode="bilinear", align_corners=False)`` and its
autograd backward.

``upsample2x_fwd`` and ``upsample2x_bwd`` take the plain version only
for a tensor on the CPU; for a CUDA tensor they launch the kernel or
raise. Neither records a graph: under autograd the upsample is
``Upsample2x`` (``ops.resize.upsample2x_bilinear``), whose backward is
``upsample2x_bwd``, and the raw forward raises on a CUDA tensor that
requires grad rather than cut the gradient silently.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ._build import check, load_library

_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}


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


def _launch(wrapper, src: torch.Tensor, dst: torch.Tensor, small) -> None:
    """Check what the kernel takes, then launch ``wrapper``'s kernel from src
    into dst and count it in ``wrapper.launches``; an empty dst launches
    nothing and counts nothing.

    ``small`` is the (N, H, W, C) of the low-resolution side.
    """
    entry = wrapper.__name__
    if src.dim() != 4 or src.dtype not in _DTYPES or not src.is_contiguous():
        raise ValueError(
            f"{entry}: needs a contiguous NHWC fp32 or bf16 tensor, got "
            f"{tuple(src.shape)} {src.dtype} contiguous={src.is_contiguous()}"
        )
    code, vec = _DTYPES[src.dtype]
    n, h, w, c = small
    if c % vec or (src.data_ptr() | dst.data_ptr()) % 16:
        raise ValueError(
            f"{entry}: the kernel moves {vec} channels of {src.dtype} at a "
            f"time; needs C % {vec} == 0 (C = {c}) and 16-byte aligned tensors"
        )
    if dst.numel() == 0:
        return
    lib = load_library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(
            getattr(lib, f"tg_{entry}")(src.data_ptr(), dst.data_ptr(), n, h, w, c, code, stream),
            entry,
        )
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
