"""K2: the fused eval-mode PConv stage, CUDA kernel and its plain version.

Replaces terra_gan_tpu/ops/pallas/pconv_kernel.py :: fused_pconv_eval
(``_kernel_s1``, ``_kernel_s2``, ``_epilogue``, and the tall-stage strip
form ``_strided_strips_s1``). One call computes

    out      = ReLU(((conv(concat(x, x_skip) * m) + bias) * ratio) * a + bb)
    ratio    = k^2 / (boxsum_k(m) + 1e-8) * (boxsum_k(m) > 0)
    new_mask = boxsum_k(m) > 0

where ``a, bb`` are the eval BatchNorm folded per channel
(``fold_batch_norm``). The kernel is ``csrc/pconv_eval.cu``: fp32, bound
by FMA throughput at the wide stages and by weight bytes at the deep
ones; the source note there gives the design. It takes every stage of
the model: k up to 7, stride 1 or 2, any channel count (enc1 has one),
outputs down to 1x1, and the decoder's (up, skip) pair as two inputs
read in place. The plain version is ``ops.pconv.partial_conv2d_split``
(F.conv2d on x*m, box-sum, renorm) followed by the folded BatchNorm and
ReLU.

``fused_pconv_eval`` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. The kernel has
no backward, as in the JAX package, where a train-mode stage is the
plain conv and BatchNorm: on a CUDA tensor under autograd it raises
rather than return a result cut from the graph.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..pconv import partial_conv2d_split
from ._build import check, load_library


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stage in plain PyTorch; same arguments as ``fused_pconv_eval``."""
    parts = (x,) if x_skip is None else (x, x_skip)
    kernel = weight.permute(2, 3, 1, 0)  # HWIO, the layout of ops.pconv
    out, new_mask = partial_conv2d_split(parts, mask, kernel, bias, stride, padding)
    return torch.relu(out * bn_a + bn_b), new_mask


def _check_cuda_args(x, x_skip, mask, weight, vecs, stride, padding):
    """Raise on what the kernel does not take; it reads raw pointers."""
    b, h, w, ca = x.shape
    cb = 0 if x_skip is None else x_skip.shape[-1]
    cout, k = weight.shape[0], weight.shape[-1]
    expect = [("x", x, (b, h, w, ca)), ("mask", mask, (b, h, w, 1)),
              ("weight", weight, (cout, ca + cb, k, k))]
    if x_skip is not None:
        expect.append(("x_skip", x_skip, (b, h, w, cb)))
    expect += [(name, v, (cout,)) for name, v in zip(("bias", "bn_a", "bn_b"), vecs)]
    for name, t, shape in expect:
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_pconv_eval: {name} has shape {tuple(t.shape)}, needs {shape}")
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"fused_pconv_eval: {name} must be a contiguous float32 tensor on "
                f"{x.device}, got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"fused_pconv_eval: {name} is not 16-byte aligned")
    if not (1 <= k <= 7 and stride in (1, 2) and 0 <= padding and cout % 4 == 0):
        raise ValueError(
            f"fused_pconv_eval: k={k} stride={stride} padding={padding} cout={cout} "
            "outside the kernel (k <= 7, stride 1 or 2, cout % 4 == 0)"
        )
    if b > 65535:
        raise ValueError(f"fused_pconv_eval: batch {b} above 65535")


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One eval PConv stage, NHWC.

    x: [B,H,W,Ca]; x_skip: optional [B,H,W,Cb], the second half of an
    implicit channel concat; mask: [B,H,W,1]; weight: nn.Conv2d's own
    [Cout,Ca+Cb,k,k]; bias, bn_a, bn_b: [Cout]. Returns
    (out [B,OH,OW,Cout], new_mask [B,OH,OW,1]), both fp32.
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
    _check_cuda_args(x, x_skip, mask, weight, (bias, bn_a, bn_b), stride, padding)
    b, h, w, ca = x.shape
    cb = 0 if x_skip is None else x_skip.shape[-1]
    cout, k = weight.shape[0], weight.shape[-1]
    # the kernel reads HWIO, Cout innermost, as float4 runs of 4 channels
    kernel = weight.permute(2, 3, 1, 0).contiguous()
    oh = (h + 2 * padding - k) // stride + 1
    ow = (w + 2 * padding - k) // stride + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"fused_pconv_eval: empty output {oh}x{ow}")
    out = torch.empty((b, oh, ow, cout), dtype=torch.float32, device=x.device)
    new_mask = torch.empty((b, oh, ow, 1), dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(
            lib.tg_pconv_eval_f32(
                x.data_ptr(), None if x_skip is None else x_skip.data_ptr(),
                mask.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
                bn_a.data_ptr(), bn_b.data_ptr(), out.data_ptr(),
                new_mask.data_ptr(), b, h, w, ca, cb, cout, k, stride, padding,
                stream,
            ),
            "fused_pconv_eval",
        )
    fused_pconv_eval.launches += 1
    return out, new_mask


fused_pconv_eval.launches = 0
