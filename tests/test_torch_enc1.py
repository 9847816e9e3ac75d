"""K2's one-channel variant (enc1), checked on the CPU.

csrc/pconv_eval.cu's ``pconv_c1_kernel`` runs enc1 (one input channel)
at every width. Here what surrounds it and its arithmetic are checked
without a card: ``plan_stage`` picks it for enc1 and for no other stage;
``plan_c1``'s tile walk gives every output pixel to exactly one tile of
one block; the separable box-sum (row sums of k, then column sums of k)
equals the direct k*k-tap sum bit for bit on 0/1 masks; and a plain-torch
emulation of the kernel's 3xTF32 arithmetic (x*m split into TF32 hi and
lo, the pack's planes, K = k*k padded with zeros to a multiple of 8 and
multiplied in k-steps of 8, per k-step lo*hi, hi*lo, then hi*hi, summed
from zero) is held to the JAX package's enc1
path: ``partial_conv2d`` at HIGHEST precision, its eval BatchNorm
(``TorchBatchNorm``) and ReLU, as ``models/generator.py`` runs enc1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from terra_gan_tpu.models.layers import TorchBatchNorm
from terra_gan_tpu.ops.pconv import partial_conv2d as jax_pconv
from terra_gan_tpu_torch.ops.cuda.pconv_kernel import (
    C1_BLOCKS_PER_SM,
    C1_MAX_COUT,
    C1_TILE,
    c1_tile_origin,
    fold_batch_norm,
    fused_pconv_eval,
    fused_pconv_eval_plain,
    pack_pconv_weight,
    plan_c1,
    plan_stage,
    tf32_round,
)
from terra_gan_tpu_torch.ops.pconv import mask_window_sum

from test_torch_kernels import ATOL, RTOL, oihw, stage_inputs, t
from test_torch_pconv_mma import H100_SMS, full_width_stages

KP = 56  # a weight row: k*k padded to 7 k-steps of 8 (csrc/pconv_eval.cu kC1KP)


def out_size(h: int, k: int, s: int) -> int:
    return (h + 2 * (k // 2) - k) // s + 1


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("batch", [1, 2, 8, 32])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("k", range(1, 8))
def test_plan_takes_the_one_channel_variant_for_one_input_channel(k, s, batch):
    o = out_size(512, k, s)
    for cout in (8, 16, 64):
        plan = plan_stage(batch * o * o, cout, 1, 0, k, H100_SMS)
        assert plan.variant == "mma_c1" and plan.splits == 1


@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("width", [64, 16])
def test_plan_takes_it_for_enc1_and_no_other_stage(width, batch):
    for name, m, n, ca, cb, k in full_width_stages(batch, width=width):
        variant = plan_stage(m, n, ca, cb, k, H100_SMS).variant
        assert (variant == "mma_c1") == (name == "enc1"), (name, variant)
        assert variant != "simt"


@pytest.mark.parametrize("ca,cb,cout", [(8, 6, 8), (3, 0, 8), (2, 0, 16), (1, 1, 8),
                                        (1, 0, 12), (1, 0, C1_MAX_COUT + 8), (6, 2, 64)])
def test_plan_keeps_simt_for_the_other_ragged_channel_counts(ca, cb, cout):
    assert plan_stage(64, cout, ca, cb, 7, H100_SMS).variant == "simt"


# (batch, input size, k, stride): enc1 at 512^2, an odd size, small sizes,
# and a 1x1 output
WALKS = [(1, 512, 7, 2), (2, 512, 7, 2), (8, 512, 7, 2), (32, 512, 7, 2), (2, 511, 7, 2),
         (8, 511, 7, 2), (2, 64, 7, 2), (2, 64, 7, 1), (2, 13, 7, 2), (3, 13, 3, 1),
         (1, 1, 7, 2), (5, 1, 1, 1)]


@pytest.mark.parametrize("b,h,k,s", WALKS, ids=[f"b{b}-{h}-k{k}-s{s}" for b, h, k, s in WALKS])
def test_tile_walk_covers_every_output_pixel_once(b, h, k, s):
    oh = ow = out_size(h, k, s)
    plan = plan_c1(b, oh, ow, H100_SMS)
    th, tw = C1_TILE
    assert plan.tiles == b * -(-oh // th) * -(-ow // tw)
    assert 1 <= plan.grid == min(plan.tiles, H100_SMS * C1_BLOCKS_PER_SM)
    seen = np.zeros((b, oh, ow), np.int64)
    per_block = []
    for z in range(plan.grid):  # block z's tiles, as the kernel walks them
        tiles = range(z, plan.tiles, plan.grid)
        per_block.append(len(tiles))
        for tile in tiles:
            bi, oy0, ox0 = c1_tile_origin(plan, tile)
            assert 0 <= bi < b and 0 <= oy0 < oh and 0 <= ox0 < ow  # no tile wholly outside
            seen[bi, oy0 : oy0 + th, ox0 : ox0 + tw] += 1
    assert (seen == 1).all()
    assert max(per_block) - min(per_block) <= 1  # the blocks' shares differ by a tile at most


# ------------------------------------------------------------ the box-sum


def padded_mask(mask: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(mask[..., 0], (p, p, p, p))  # [B, H + 2p, W + 2p], the ones-conv's padding


def separable_box_sum(mask, k: int, s: int, p: int) -> torch.Tensor:
    """The kernel's box-sum: row sums of k at each output column, each from
    0 in kx order, then column sums of k of those, from 0 in ky order."""
    m = padded_mask(mask, p)
    oh, ow = (m.shape[1] - k) // s + 1, (m.shape[2] - k) // s + 1
    rows = torch.zeros((m.shape[0], m.shape[1], ow))
    for kx in range(k):
        rows = rows + m[:, :, kx : kx + s * (ow - 1) + 1 : s]
    out = torch.zeros((m.shape[0], oh, ow))
    for ky in range(k):
        out = out + rows[:, ky : ky + s * (oh - 1) + 1 : s, :]
    return out[..., None]


def direct_box_sum(mask, k: int, s: int, p: int) -> torch.Tensor:
    """The k*k taps of each window summed one by one."""
    m = padded_mask(mask, p)
    oh, ow = (m.shape[1] - k) // s + 1, (m.shape[2] - k) // s + 1
    out = torch.zeros((m.shape[0], oh, ow))
    for ky in range(k):
        for kx in range(k):
            out = out + m[:, ky : ky + s * (oh - 1) + 1 : s, kx : kx + s * (ow - 1) + 1 : s]
    return out[..., None]


@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("k", range(1, 8))
def test_separable_box_sum_equals_the_direct_sum_bitwise(k, s):
    rng = np.random.default_rng(10 * k + s)
    for hw in (37, 64):
        m = t((rng.random((2, hw, hw, 1)) > 0.5).astype(np.float32))
        m[0, 4:20, 8:30] = 0  # a solid hole: windows with no valid tap
        m[1] = 1.0            # and a tile with no hole
        got = separable_box_sum(m, k, s, k // 2)
        assert torch.equal(got, direct_box_sum(m, k, s, k // 2))
        assert torch.equal(got, mask_window_sum(m, k, k, s, k // 2))  # the plain version's
        assert (got == 0).any() and (got == k * k).any()


# ----------------------------------------------------------- the arithmetic


def k_steps(kk: int):
    """The kernel's k-steps over K = kk taps padded with zeros to a
    multiple of 8: slices of 8 (m16n8k8)."""
    return [slice(8 * st, 8 * st + 8) for st in range(-(-kk // 8))]


def test_k_steps_cover_every_tap_and_pad_at_most_3_or_7():
    for k in range(1, 8):
        kk = k * k
        steps = k_steps(kk)
        covered = [i for st in steps for i in range(st.start, st.stop)]
        assert covered == list(range(len(covered))) and kk <= len(covered) <= KP
        assert len(covered) - kk == -kk % 8 <= 7
    assert [(st.start, st.stop) for st in k_steps(49)][-1] == (48, 56)  # enc1: 56 taps
    assert len(k_steps(49)) == 7 and len(k_steps(9)) == 2 and len(k_steps(16)) == 2


def emulated_c1(x, mask, weight, bias, stride, padding, bn_a, bn_b, terms=3):
    """The one-channel kernel's arithmetic in plain torch: x*m split into
    TF32 hi and lo; the pack's planes as [Cout][k*k] rows padded with
    zeros to KP; each window's taps gathered, a padded tap reading tap 0;
    per k-step of 8 taps (k_steps) lo*hi, hi*lo, then hi*hi added to a sum
    from zero (terms=1: hi*hi alone, plain TF32); the separable box-sum;
    then the epilogue ((acc + bias) * ratio) * a + bb and a ReLU that keeps
    NaN."""
    b, h, w, _ = x.shape
    cout, _, k, _ = weight.shape
    kk = k * k
    oh, ow = (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1
    xm = x * mask
    x_hi = tf32_round(xm)
    x_lo = tf32_round(xm - x_hi)
    w_hi, w_lo = (F.pad(p.reshape(cout, kk), (0, KP - kk)) for p in pack_pconv_weight(weight))

    def taps(v):  # [B, OH*OW, KP]
        c = F.unfold(v.permute(0, 3, 1, 2), k, padding=padding, stride=stride).transpose(1, 2)
        return torch.cat([c, c[..., :1].expand(b, oh * ow, KP - kk)], -1)

    a_hi, a_lo = taps(x_hi), taps(x_lo)
    acc = torch.zeros((b, oh * ow, cout))
    for ks in k_steps(kk):
        if terms == 3:
            acc = acc + a_lo[..., ks] @ w_hi[:, ks].T
            acc = acc + a_hi[..., ks] @ w_lo[:, ks].T
        acc = acc + a_hi[..., ks] @ w_hi[:, ks].T
    acc = acc.reshape(b, oh, ow, cout)
    msum = separable_box_sum(mask, k, stride, padding)
    valid = msum > 0
    ratio = torch.where(valid, kk / (msum + 1e-8), torch.zeros_like(msum))
    return torch.relu(((acc + bias) * ratio) * bn_a + bn_b), valid.float()


def jax_enc1(x, m, w, b, bn, stride, padding):
    """enc1 as the JAX model runs it (the Pallas kernel takes no cin < 8):
    partial_conv2d at HIGHEST precision, TorchBatchNorm on its running
    statistics, ReLU."""
    out, new_mask = jax_pconv(jnp.asarray(x), jnp.asarray(m), jnp.asarray(w), jnp.asarray(b),
                              stride, padding, precision=jax.lax.Precision.HIGHEST)
    variables = {"params": {"scale": jnp.asarray(bn["bn_scale"]), "bias": jnp.asarray(bn["bn_bias"])},
                 "batch_stats": {"mean": jnp.asarray(bn["bn_mean"]), "var": jnp.asarray(bn["bn_var"])}}
    y = TorchBatchNorm().apply(variables, out, use_running_average=True)
    return np.asarray(jax.nn.relu(y)), np.asarray(new_mask)


# (holes, k, stride, size, Cout): enc1's geometry at widths 64, 16 and 8,
# masks with holes, none valid, all valid, and a NaN under a zero mask
C1_CASES = [("holes", 7, 2, 64, 64), ("zeros", 7, 2, 64, 64), ("ones", 7, 2, 64, 64),
            ("nan", 7, 2, 64, 64), ("holes", 7, 2, 33, 16), ("holes", 3, 1, 13, 8),
            ("nan", 5, 1, 20, 16)]


def c1_case(holes, k, hw, cout):
    x, _, m, w, b, bn = stage_inputs(100 * k + hw + cout + len(holes), hw, 1, 0, cout, k)
    if holes == "zeros":
        m[:] = 0.0
    elif holes == "ones":
        m[:] = 1.0
    elif holes == "nan":
        x[0, hw // 3, hw // 2, 0], m[0, hw // 3, hw // 2, 0] = np.nan, 0.0
    return x, m, w, b, bn


@pytest.mark.parametrize("holes,k,s,hw,cout", C1_CASES,
                         ids=[f"{c[0]}-k{c[1]}-s{c[2]}-{c[3]}-c{c[4]}" for c in C1_CASES])
def test_3xtf32_emulation_matches_the_jax_enc1_path(holes, k, s, hw, cout):
    x, m, w, b, bn = c1_case(holes, k, hw, cout)
    want, want_m = jax_enc1(x, m, w, b, bn, s, k // 2)
    a, bb = fold_batch_norm(*(t(bn[n]) for n in ("bn_scale", "bn_bias", "bn_mean", "bn_var")))
    args = (t(x), t(m), oihw(w), t(b), s, k // 2, a, bb)
    got, got_m = emulated_c1(*args)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    # fp32 sums in another order (tests/test_pallas_kernel.py's tolerance);
    # NaN exactly where JAX has it
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert np.isnan(want).any() == (holes == "nan")
    plain, plain_m = fused_pconv_eval_plain(*args)  # the wrapper's CPU path, the card's reference
    np.testing.assert_allclose(plain.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(plain_m, got_m)
    cpu, _ = fused_pconv_eval(*args)
    assert torch.equal(torch.isnan(cpu), torch.isnan(plain))
    assert torch.equal(cpu.nan_to_num(), plain.nan_to_num())


def test_the_emulation_sees_a_tf32_sized_error():
    x, m, w, b, bn = c1_case("holes", 7, 64, 64)
    want, _ = jax_enc1(x, m, w, b, bn, 2, 3)
    a, bb = fold_batch_norm(*(t(bn[n]) for n in ("bn_scale", "bn_bias", "bn_mean", "bn_var")))
    args = (t(x), t(m), oihw(w), t(b), 2, 3, a, bb)
    err3 = np.abs(emulated_c1(*args)[0].numpy() - want).max()
    err1 = np.abs(emulated_c1(*args, terms=1)[0].numpy() - want).max()
    # hi*hi alone (plain TF32) fails the tolerance the 3xTF32 sum passes
    assert not np.allclose(emulated_c1(*args, terms=1)[0].numpy(), want, rtol=RTOL, atol=ATOL)
    assert err1 >= 30 * err3, (err1, err3)


def test_padded_taps_read_tap_0_against_zero_weights():
    # K = 9 (k = 3) pads 47 taps: a NaN in tap 0 of one window is NaN there
    # however it is summed, and finite elsewhere; K = 49 pads 7
    x, m, w, b, bn = c1_case("holes", 3, 12, 8)
    a, bb = fold_batch_norm(*(t(bn[n]) for n in ("bn_scale", "bn_bias", "bn_mean", "bn_var")))
    xt = t(x)
    xt[0, 0, 0, 0] = float("nan")
    got, _ = emulated_c1(xt, t(m), oihw(w), t(b), 1, 1, a, bb)
    want, _ = fused_pconv_eval_plain(xt, t(m), oihw(w), t(b), 1, 1, a, bb)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[0, :2, :2]).all() and not torch.isnan(got[1]).any()
