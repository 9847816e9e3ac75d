"""K2's 3xTF32 scheme and split-K plan, checked on the CPU.

The MMA variant of csrc/pconv_eval.cu rounds x*m and the weight to
TF32 (hi) and their residuals to TF32 (lo), and sums lo*hi + hi*lo +
hi*hi in fp32. Here that arithmetic is emulated in plain torch (three
fp32 convolutions of the split operands) and held to the JAX Pallas
kernel in interpret mode, and on a width-16 model's dec2 features to the
fp32 plain path, where it must pass the card's 1e-6 gate and the same
emulation with hi alone (plain TF32) must read at least 10x its error.
The split-K planner, a pure function of the shapes, is checked to give
every K index to exactly one split at the full-width model's stages.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from terra_gan_tpu.ops.pallas.pconv_kernel import fused_pconv_eval as jax_fused
from terra_gan_tpu_torch.ops.cuda.pconv_kernel import (
    CHUNK_CHANNELS,
    MIN_CHUNKS_PER_SPLIT,
    fold_batch_norm,
    fused_pconv_eval,
    fused_pconv_eval_plain,
    pack_pconv_weight,
    pack_pconv_weights,
    plan_stage,
    split_chunk_range,
    tf32_round,
)
from terra_gan_tpu_torch.models.generator import STAGES
from terra_gan_tpu_torch.ops.cuda.upsample_kernel import upsample2x_fwd_plain
from terra_gan_tpu_torch.ops.pconv import mask_window_sum
from terra_gan_tpu_torch.utils.weights import init_generator

from test_torch_kernels import ATOL, RTOL, oihw, stage_inputs, t

FEAT_NRMSE_TOL = 1e-6  # chip_smoke.py's gate on dec2's features
H100_SMS = 132


def emulated_stage(x, mask, weight, bias, stride, padding, bn_a, bn_b, x_skip=None,
                   packed=None, terms=3):
    """K2's MMA arithmetic in plain torch: x*m and the weight split into
    TF32 hi and lo, lo*hi + hi*lo + hi*hi as three fp32 convolutions
    (terms=1: hi*hi alone, i.e. plain TF32), then the epilogue."""
    xm = (x if x_skip is None else torch.cat([x, x_skip], -1)) * mask
    x_hi = tf32_round(xm)
    x_lo = tf32_round(xm - x_hi)
    w_hi, w_lo = (w.permute(0, 3, 1, 2) for w in pack_pconv_weight(weight))  # OHWI -> OIHW

    def conv(a, w):
        return F.conv2d(a.permute(0, 3, 1, 2), w, stride=stride, padding=padding)

    acc = conv(x_hi, w_hi)
    if terms == 3:
        acc = conv(x_lo, w_hi) + conv(x_hi, w_lo) + acc
    acc = acc.permute(0, 2, 3, 1)
    k = weight.shape[-1]
    msum = mask_window_sum(mask, k, k, stride, padding)
    valid = msum > 0
    ratio = torch.where(valid, (k * k) / (msum + 1e-8), torch.zeros_like(msum))
    return torch.relu(((acc + bias) * ratio) * bn_a + bn_b), valid.to(mask.dtype)


def nrmse(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).pow(2).mean().sqrt() / b.abs().max()).item()


def test_pack_rounds_to_tf32_and_reconstructs_the_weight():
    rng = np.random.default_rng(0)
    w = t((rng.standard_normal((16, 8, 3, 3)) * np.exp(rng.uniform(-20, 20, (16, 8, 3, 3))))
          .astype(np.float32))
    hi, lo = pack_pconv_weight(w)
    assert hi.shape == lo.shape == (16, 3, 3, 8) and hi.is_contiguous() and lo.is_contiguous()
    for plane in (hi, lo):
        assert (plane.view(torch.int32) & 0x1FFF).eq(0).all()  # 10 mantissa bits left
    ohwi = w.permute(0, 2, 3, 1).double()
    assert ((hi.double() + lo.double() - ohwi).abs() <= 2.0**-21 * ohwi.abs()).all()
    assert ((hi.double() - ohwi).abs() <= 2.0**-11 * ohwi.abs()).all()


def test_tf32_rounding_is_to_nearest_with_ties_away_from_zero():
    half, ulp = 2.0**-11, 2.0**-10  # half a TF32 ulp at 1, and the ulp
    cases = {
        1 + half: 1 + ulp,                # a tie: away (to even would give 1)
        -(1 + half): -(1 + ulp),
        1 + 3 * half: 1 + 2 * ulp,        # a tie whose even neighbour is also away
        1 + half - 2.0**-23: 1.0,         # just under a tie: down
        1 + half + 2.0**-23: 1 + ulp,
        2.0**-130: 2.0**-130,             # a subnormal with no bits below the cut
        2.0**-140: 0.0,                   # one under half a TF32 ulp of 0
        0.0: 0.0,
        float("inf"): float("inf"),
    }
    got = tf32_round(torch.tensor(list(cases), dtype=torch.float32))
    assert got.tolist() == list(cases.values())
    assert torch.isnan(tf32_round(torch.tensor([float("nan")]))).all()
    hi, lo = pack_pconv_weight(torch.tensor([float("inf"), float("nan")]).view(1, 2, 1, 1))
    assert hi.flatten()[0] == float("inf") and torch.isnan(hi.flatten()[1])
    assert lo.flatten().tolist() == [0.0, 0.0]  # hi alone carries inf and NaN


@pytest.mark.parametrize(
    "k,s,ca,cb,cout,hw",
    [
        (3, 1, 8, 0, 16, 32),
        (3, 2, 8, 0, 16, 32),
        (5, 2, 16, 0, 8, 33),    # odd spatial size
        (3, 1, 16, 8, 24, 17),   # decoder form: (up, skip) as two inputs
        (3, 1, 8, 8, 8, 8),      # decoder form at a deep-stage size
    ],
)
def test_3xtf32_emulation_matches_pallas_kernel(k, s, ca, cb, cout, hw):
    x, xs, m, w, b, bn = stage_inputs(k * 100 + s + cb, hw, ca, cb, cout, k)
    xc = x if xs is None else np.concatenate([x, xs], -1)
    want, want_m = jax_fused(
        jnp.asarray(xc), jnp.asarray(m), jnp.asarray(w), jnp.asarray(b), s, k // 2,
        **{n: jnp.asarray(v) for n, v in bn.items()}, relu=True, interpret=True,
    )
    a, bb = fold_batch_norm(*(t(bn[n]) for n in ("bn_scale", "bn_bias", "bn_mean", "bn_var")))
    got, got_m = emulated_stage(t(x), t(m), oihw(w), t(b), s, k // 2, a, bb,
                                x_skip=None if xs is None else t(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_3xtf32_passes_the_dec2_gate_that_plain_tf32_fails():
    model = init_generator(16, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    x = t(rng.random((2, 64, 64, 1), dtype=np.float32))
    m = t((rng.random((2, 64, 64, 1)) > 0.3).astype(np.float32))
    m[:, 16:40, 8:32] = 0

    def dec2(stage):
        with torch.inference_mode():
            return model.decode(x * m, m, stage, upsample2x_fwd_plain)

    want, want_m = dec2(fused_pconv_eval_plain)
    got3, got3_m = dec2(emulated_stage)
    got1, _ = dec2(lambda *a, **kw: emulated_stage(*a, **kw, terms=1))
    err3, err1 = nrmse(got3, want), nrmse(got1, want)
    assert want.std() > 0 and torch.equal(got3_m, want_m)
    assert err3 <= FEAT_NRMSE_TOL, err3
    assert err1 >= 10 * err3, (err1, err3)


def full_width_stages(batch: int, size: int = 512, width: int = 64):
    """(name, M, N, Ca, Cb, k) of the 14 stages of the full-width model."""
    w, out = width, []
    enc = [(1, w, 7), (w, 2 * w, 5), (2 * w, 4 * w, 5), (4 * w, 8 * w, 3),
           (8 * w, 8 * w, 3), (8 * w, 8 * w, 3), (8 * w, 8 * w, 3)]
    for i, (cin, cout, k) in enumerate(enc):
        oh = size >> (i + 1)
        out.append((f"enc{i + 1}", batch * oh * oh, cout, cin, 0, k))
    dec = [(7, 8 * w, 8 * w, 8 * w), (6, 8 * w, 8 * w, 8 * w), (5, 8 * w, 8 * w, 8 * w),
           (4, 8 * w, 4 * w, 4 * w), (3, 4 * w, 2 * w, 2 * w), (2, 2 * w, w, w), (1, w, 0, w)]
    for n, c_up, c_skip, cout in dec:
        oh = size >> (n - 1)
        out.append((f"dec{n}", batch * oh * oh, cout, c_up, c_skip, 3))
    return out


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_split_k_plan_covers_every_k_index_once(batch):
    split_stages = set()
    for name, m, n, ca, cb, k in full_width_stages(batch):
        plan = plan_stage(m, n, ca, cb, k, H100_SMS)
        if name == "enc1":  # one input channel: the one-channel variant, unsplit
            assert plan.variant == "mma_c1" and plan.splits == 1
            continue
        assert plan.variant == "mma"
        nca, ncb = -(-ca // CHUNK_CHANNELS), -(-cb // CHUNK_CHANNELS)
        assert plan.chunks == k * k * (nca + ncb)
        assert plan.splits == 1 or plan.chunks // plan.splits >= MIN_CHUNKS_PER_SPLIT
        # the K index (tap, channel) of every chunk's real channels, split by split
        seen = np.zeros(k * k * (ca + cb), np.int64)
        bounds = [split_chunk_range(z, plan.splits, plan.chunks) for z in range(plan.splits)]
        assert bounds[0][0] == 0 and bounds[-1][1] == plan.chunks
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(bounds, bounds[1:] + [(plan.chunks,)]))
        for begin, end in bounds:
            for c in range(begin, end):
                tap, sub = divmod(c, nca + ncb)
                c0 = sub * CHUNK_CHANNELS if sub < nca else ca + (sub - nca) * CHUNK_CHANNELS
                c1 = min(c0 + CHUNK_CHANNELS, ca if sub < nca else ca + cb)
                seen[tap * (ca + cb) + c0 : tap * (ca + cb) + c1] += 1
        assert (seen == 1).all(), name
        if plan.splits > 1:
            split_stages.add(name)
    # the deep stages, which fill few of the 132 SMs, are split
    assert {"enc5", "enc6", "enc7", "dec6", "dec7"} <= split_stages
    assert not {"enc2", "dec3", "dec2", "dec1"} & split_stages


def test_plan_takes_simt_for_channels_the_copies_cannot_take():
    # one input channel (enc1) has its own variant; other ragged counts are SIMT's
    assert plan_stage(64, 8, 1, 0, 7, H100_SMS).variant == "mma_c1"
    assert plan_stage(64, 8, 8, 6, 3, H100_SMS).variant == "simt"
    assert plan_stage(64, 8, 1, 1, 3, H100_SMS).variant == "simt"
    plan = plan_stage(64, 8, 8, 8, 3, H100_SMS)
    assert plan.variant == "mma" and plan.tile == 1 and plan.chunks == 9 * 2


def planes_equal(a, b) -> bool:
    return all(torch.equal(p, q) for p, q in zip(a, b))


def test_model_repacks_its_cached_planes_when_the_weight_changes():
    # nothing is cached any more: every call packs the weight as it is now
    model = init_generator(8, torch.Generator().manual_seed(0), "cpu")
    st = model.enc3
    first = st.packed_weight()
    assert planes_equal(first, pack_pconv_weight(st.input_conv.weight))
    sd = model.state_dict()
    sd["enc3.input_conv.weight"] = sd["enc3.input_conv.weight"] * 1.5
    model.load_state_dict(sd)
    second = st.packed_weight()
    assert not torch.equal(second[0], first[0])
    assert planes_equal(second, pack_pconv_weight(st.input_conv.weight))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    st.input_conv.weight.grad = torch.ones_like(st.input_conv.weight)
    opt.step()
    third = st.packed_weight()
    assert not torch.equal(third[0], second[0])
    assert planes_equal(third, pack_pconv_weight(st.input_conv.weight))


@pytest.mark.parametrize("edit", ["mul_", "copy_"])
def test_planes_follow_an_in_place_write_through_data(edit):
    # a write through .data moves no version counter: a cache keyed on it went stale
    model = init_generator(8, torch.Generator().manual_seed(1), "cpu")
    w = model.dec3.input_conv.weight
    before, version = model.dec3.packed_weight(), w._version
    if edit == "mul_":
        w.data.mul_(-2.0)
    else:
        w.data.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(2)))
    assert w._version == version  # the hole: nothing a cache could key on moved
    after = model.dec3.packed_weight()
    assert not torch.equal(after[0], before[0])
    assert planes_equal(after, pack_pconv_weight(w))


def test_model_packs_every_stage_in_one_call():
    model = init_generator(8, torch.Generator().manual_seed(3), "cpu")
    assert model.packed_weights() is None  # K2's plain version on the CPU reads no planes
    weights = [getattr(model, n).input_conv.weight for n in STAGES]
    assert len(weights) == 14
    planes = pack_pconv_weights(weights)
    assert len(planes) == 14
    for w, p in zip(weights, planes):
        assert planes_equal(p, pack_pconv_weight(w))
    launches = pack_pconv_weights.launches
    x, m = torch.rand((1, 32, 32, 1)), torch.ones((1, 32, 32, 1))
    with torch.inference_mode():
        model(x, m)
    assert pack_pconv_weights.launches == launches  # no kernel on the CPU


def test_cpu_wrapper_ignores_packed_planes():
    x, xs, m, w, b, bn = stage_inputs(3, 16, 8, 4, 8, 3)
    a, bb = fold_batch_norm(*(t(bn[n]) for n in ("bn_scale", "bn_bias", "bn_mean", "bn_var")))
    args = (t(x), t(m), oihw(w), t(b), 1, 1, a, bb)
    launches = fused_pconv_eval.launches
    got = fused_pconv_eval(*args, x_skip=t(xs), packed=pack_pconv_weight(oihw(w)))
    want = fused_pconv_eval_plain(*args, x_skip=t(xs))
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    assert fused_pconv_eval.launches == launches
