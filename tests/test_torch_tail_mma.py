"""K3's 3xTF32 arithmetic, checked on the CPU.

csrc/decoder_tail.cu runs dec1 on the tensor cores: V = K1(d) * m512 is
split once into TF32 hi and lo planes, the weights the same way, and
each chunk of K (one tap x 8 input channels, one MMA k-step) sums lo*hi
+ hi*lo + hi*hi from zero before it is added to the running sum in
fp32. Here that arithmetic is emulated in plain torch (the chunk's
products in IEEE fp32 matmuls, in the kernel's chunk and tap order) and
held to the JAX package's ``tail_reference`` and its Pallas kernel in
interpret mode, in both forms; on spread weights it must pass the
card's 1e-5 composite gate, and the same emulation with hi alone (plain
TF32) must read at least 10x its error.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from terra_gan_tpu.ops.pallas.tail_kernel import fused_decoder_tail as jax_tail
from terra_gan_tpu.ops.pallas.tail_kernel import tail_reference
from terra_gan_tpu_torch.ops.cuda.pconv_kernel import fold_batch_norm, tf32_round
from terra_gan_tpu_torch.ops.cuda.tail_kernel import fused_decoder_tail_plain
from terra_gan_tpu_torch.ops.cuda.upsample_kernel import upsample2x_fwd_plain
from terra_gan_tpu_torch.ops.pconv import mask_window_sum
from terra_gan_tpu_torch.ops.resize import upsample2x_nearest

from test_torch_tail import make_args, nrmse

ATOL = 1e-5            # the composite: fp32 sums in another order
K3_NRMSE_TOL = 1e-5    # chip_smoke.py's gate on the composite
CHUNK = 8              # input channels of one MMA k-step


def split(v: torch.Tensor):
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def nchw(t):
    return t.permute(0, 3, 1, 2)


def emulated_tail(d, dm, x, xm, k_main, k_skip, bias, bn_scale, bn_bias, bn_mean, bn_var,
                  k_fin, b_fin, eps=1e-5, terms=3):
    """K3's arithmetic in plain torch (terms=1: hi*hi alone, plain TF32)."""
    b, h, w, c = d.shape
    m512 = torch.maximum(upsample2x_nearest(dm), xm)
    v_hi, v_lo = (F.pad(p, (0, 0, 1, 1, 1, 1)) for p in split(upsample2x_fwd_plain(d) * m512))
    w_hi = tf32_round(k_main)
    w_lo = torch.where(torch.isfinite(w_hi), tf32_round(k_main - w_hi), torch.zeros_like(w_hi))
    acc = torch.zeros((b, 2 * h, 2 * w, c))
    for c0 in range(0, c, CHUNK):
        for ky in range(3):
            for kx in range(3):
                a_hi, a_lo = (p[:, ky : ky + 2 * h, kx : kx + 2 * w, c0 : c0 + CHUNK]
                              for p in (v_hi, v_lo))
                b_hi, b_lo = (p[ky, kx, c0 : c0 + CHUNK] for p in (w_hi, w_lo))
                part = a_hi @ b_hi
                if terms == 3:
                    part = a_lo @ b_hi + a_hi @ b_lo + part
                acc = acc + part
    if k_skip is not None:  # one input channel, fp32
        acc = acc + nchw_conv(x * m512, k_skip)
    s = mask_window_sum(m512, 3, 3, 1, 1)
    ratio = torch.where(s > 0, 9.0 / (s + 1e-8), torch.zeros_like(s))
    a, bb = fold_batch_norm(bn_scale, bn_bias, bn_mean, bn_var, eps)
    dec1 = torch.relu(((acc + bias) * ratio) * a + bb)
    o = torch.sigmoid(nchw_conv(dec1, k_fin) + b_fin)
    return o * (1.0 - xm) + x * xm


def nchw_conv(t, k_hwio):
    """3x3 conv, zero padding 1, NHWC in and out, HWIO weights."""
    return F.conv2d(nchw(t), k_hwio.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)


def torch_args(args, skip=True):
    out = [torch.from_numpy(np.array(a, copy=True)) for a in args]
    if not skip:
        out[5] = None
    return out


@pytest.mark.parametrize("h,c,skip", [
    (32, 8, True),     # 64^2 composite at width 8, the JAX form
    (64, 16, False),   # 128^2 at width 16, the model's one-input form
])
def test_emulation_matches_the_jax_tail(h, c, skip):
    args = make_args(10 + h + c, b=1, h=h, c=c)
    got = emulated_tail(*torch_args(args, skip)).numpy()
    if not skip:
        args[5] = np.zeros_like(args[5])  # the JAX function's one-input form
    ref = np.asarray(tail_reference(*map(jnp.asarray, args)))
    pallas = np.asarray(jax_tail(*map(jnp.asarray, args), interpret=True, compute=jnp.float32))
    assert got.shape == ref.shape == (1, 2 * h, 2 * h, 1)
    assert np.abs(got - ref).max() <= ATOL
    assert np.abs(got - pallas).max() <= ATOL
    assert nrmse(got, ref) <= K3_NRMSE_TOL


def spread_args(c: int, h: int, seed: int):
    """Spread weights as chip_smoke.py's k3 phase takes them: features at
    unit RMS and xm = 0, so every pixel is the tail's own output."""
    args = torch_args(make_args(seed, b=2, h=h, c=c, xm_mode="zeros"))
    args[0] = args[0] / args[0].pow(2).mean().sqrt()
    return args


@pytest.mark.parametrize("c,skip", [(16, False), (64, True)])
def test_3xtf32_passes_the_composite_gate_that_plain_tf32_fails(c, skip):
    args = spread_args(c, 24, 20 + c)
    if not skip:
        args[5] = None
    want = fused_decoder_tail_plain(*args)
    err3 = nrmse(emulated_tail(*args), want)
    err1 = nrmse(emulated_tail(*args, terms=1), want)
    hole = want.double()
    assert torch.log(hole / (1 - hole)).std() > 0.05  # the logits spread
    assert err3 <= K3_NRMSE_TOL, err3
    assert err1 >= 10 * err3, (err1, err3)


@pytest.mark.parametrize("c", [4, 12])
def test_emulation_pads_a_ragged_last_chunk(c):
    # C not a multiple of the 8-channel chunk: the copy zero-fills the rest
    args = torch_args(make_args(30 + c, b=1, h=12, c=c))
    got = emulated_tail(*args)
    want = fused_decoder_tail_plain(*args)
    assert (got - want).abs().max().item() <= ATOL

