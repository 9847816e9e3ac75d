"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so it also runs where JAX is
not installed; there, skip the JAX-forcing conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""

from __future__ import annotations

import copy
import math

import numpy as np
import pytest
import torch

from terra_gan_tpu_torch.ops.cuda.pconv_kernel import (
    VARIANTS as K2_VARIANTS,
    fold_batch_norm,
    fused_pconv_eval,
    fused_pconv_eval_plain,
    fused_pconv_train,
    fused_pconv_train_plain,
    pack_pconv_weight,
    pack_pconv_weights,
    plan_stage,
    sm_count,
)
from terra_gan_tpu_torch.models.generator import STAGES, PConvUNet
from terra_gan_tpu_torch.ops.pconv import mask_window_sum
from terra_gan_tpu_torch.ops.cuda.upsample_kernel import (
    Upsample2x,
    upsample2x_bwd,
    upsample2x_bwd_plain,
    upsample2x_fwd,
    upsample2x_fwd_plain,
)
from terra_gan_tpu_torch.ops.cuda.tail_kernel import fused_decoder_tail, fused_decoder_tail_plain
from terra_gan_tpu_torch.ops.cuda.ffc_kernel import ffc_local, ffc_local_kernel, ffc_local_plain
from terra_gan_tpu_torch.models.lama import FFCResNetGenerator
from terra_gan_tpu_torch.ops.resize import upsample2x_bilinear
from terra_gan_tpu_torch.cli import doctor
from terra_gan_tpu_torch.cli.probe_cuda import probe_cases, probe_inputs
from terra_gan_tpu_torch.evaluation.inference import OUTPUT_SIZE, evaluate
from terra_gan_tpu_torch.ops.cuda.probe_kernels import (
    PLAIN,
    VARIANTS,
    plan_probe,
    probe_lane_concat_dot,
    probe_lane_reduce,
    probe_mask_broadcast,
    probe_matvec_dot,
    probe_row_build,
)
from terra_gan_tpu_torch.parallel.infer import BatchedInpainter
from terra_gan_tpu_torch.training.state import GANTrainState
from terra_gan_tpu_torch.training.step import make_train_step
from terra_gan_tpu_torch.utils.weights import init_discriminator, init_generator, init_vgg

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-4, 1e-5  # fp32 sums in another order
NRMSE_TOL = 1e-5       # the composite
FEAT_NRMSE_TOL = 1e-6  # dec2's features: fp32 sums in another order, far under TF32's error
# the 7 decoder upsamples' inputs (H, C) of the full-width 512^2 model
DECODER_SHAPES = [(4, 512), (8, 512), (16, 512), (32, 512), (64, 256), (128, 128), (256, 64)]


def nrmse(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.abs(b).max(), 1e-12))


def capture_dec2(model, run):
    """run()'s result and the dec2 features of each forward it made."""
    feats = []
    hook = model.dec2.register_forward_hook(lambda mod, args, out: feats.append(out[0]))
    try:
        out = run()
    finally:
        hook.remove()
    return out, torch.cat(feats).cpu().numpy()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def stage_args(seed, hw, ca, cb, cout, k, s, dev, b=2):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((b, hw, hw, ca), generator=g)
    xs = torch.rand((b, hw, hw, cb), generator=g) if cb else None
    m = (torch.rand((b, hw, hw, 1), generator=g) > 0.4).float()
    m[:, hw // 4 : hw // 2, hw // 4 : hw // 2] = 0
    w = torch.randn((cout, ca + cb, k, k), generator=g) * 0.1
    b = torch.randn(cout, generator=g) * 0.1
    a, bb = fold_batch_norm(torch.rand(cout, generator=g) + 0.5, torch.randn(cout, generator=g) * 0.1,
                            torch.randn(cout, generator=g) * 0.1, torch.rand(cout, generator=g) + 0.5)
    args = [v.to(dev) for v in (x, m, w, b)] + [s, k // 2, a.to(dev), bb.to(dev)]
    return args, None if xs is None else xs.to(dev)


@pytest.mark.parametrize(
    "k,s,ca,cb,cout,hw",
    [(7, 2, 1, 0, 64, 64),      # enc1: one input channel
     (5, 2, 64, 0, 128, 33),    # odd size
     (3, 1, 64, 32, 64, 17),    # decoder form: (up, skip) read in place
     (3, 2, 16, 0, 36, 2),      # 1x1 output, Cout not a multiple of 64
     (3, 1, 32, 32, 32, 1),
     (7, 2, 3, 0, 16, 64),      # SIMT: ragged channel counts
     (3, 1, 6, 2, 40, 17),      # SIMT in the decoder form
     (5, 2, 1, 0, 12, 13)],     # SIMT: one channel, Cout not a multiple of 8
)
def test_pconv_kernel_matches_plain(card, k, s, ca, cb, cout, hw):
    args, skip = stage_args(k + ca + hw, hw, ca, cb, cout, k, s, card)
    plan = plan_of(args, skip)
    variant = "mma_split" if plan.splits > 1 else plan.variant
    # the ragged cases (not enc1's one channel at Cout % 8 == 0) reach SIMT
    ragged = bool(ca % 4 or cb % 4) and not (ca == 1 and cb == 0 and cout % 8 == 0)
    assert (variant == "simt") == ragged
    before, variants = fused_pconv_eval.launches, dict(fused_pconv_eval.variants)
    got, got_m = fused_pconv_eval(*args, x_skip=skip)
    want, want_m = fused_pconv_eval_plain(*args, x_skip=skip)
    torch.cuda.synchronize()
    assert fused_pconv_eval.launches == before + 1
    assert k2_used(variants)[variant] == 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(got_m, want_m)


def plan_of(args, skip):
    x, weight = args[0], args[2]
    b, h, w, ca = x.shape
    k, s, p = weight.shape[-1], args[4], args[5]
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    return plan_stage(b * oh * ow, weight.shape[0], ca, 0 if skip is None else skip.shape[-1],
                      k, sm_count(x.device))


@pytest.mark.parametrize(
    "b,k,s,ca,cb,cout,hw",
    [(8, 3, 1, 512, 512, 512, 8),   # dec7 at batch 8: (up, skip) of 512 each
     (1, 3, 1, 512, 512, 512, 8),   # and at batch 1
     (8, 3, 2, 512, 0, 512, 8),     # enc7 at batch 8: 8x8 -> 4x4
     (1, 3, 2, 512, 0, 512, 8),
     (1, 3, 1, 40, 24, 36, 5)],     # ragged chunks, Cout 36, 25 pixels split
)
def test_pconv_kernel_split_k_matches_plain(card, b, k, s, ca, cb, cout, hw):
    args, skip = stage_args(b + k + ca + cb, hw, ca, cb, cout, k, s, card, b=b)
    plan = plan_of(args, skip)
    assert plan.variant == "mma" and plan.splits > 1
    before = dict(fused_pconv_eval.variants)
    got, got_m = fused_pconv_eval(*args, x_skip=skip)
    want, want_m = fused_pconv_eval_plain(*args, x_skip=skip)
    torch.cuda.synchronize()
    used = {v: n - before[v] for v, n in fused_pconv_eval.variants.items()}
    assert used == {**dict.fromkeys(K2_VARIANTS, 0), "mma_split": 1, "split_reduce": 1}
    # of max|plain|, as chip_smoke.py's K2 gate: sums of up to 9216 fp32
    # products in another order, at outputs of a few units
    assert (got - want).abs().max().item() <= RTOL * want.abs().max().item()
    assert torch.equal(got_m, want_m)


@pytest.mark.parametrize("split", [False, True])
def test_pconv_kernel_is_bitwise_reproducible(card, split):
    b, hw = (1, 16) if split else (8, 64)
    args, skip = stage_args(11, hw, 256, 256, 256, 3, 1, card, b=b)
    assert (plan_of(args, skip).splits > 1) == split
    packed = pack_pconv_weight(args[2])
    first = fused_pconv_eval(*args, x_skip=skip, packed=packed)
    for _ in range(3):
        again = fused_pconv_eval(*args, x_skip=skip)  # packed per call: the same planes
        assert all(torch.equal(a, c) for a, c in zip(first, again))


def test_model_packed_weights_follow_load_state_dict(card):
    model = init_generator(16, torch.Generator().manual_seed(7), card)
    g = np.random.default_rng(8)
    x = torch.from_numpy(g.random((2, 64, 64, 1), dtype=np.float32)).to(card)
    m = torch.from_numpy((g.random((2, 64, 64, 1)) > 0.3).astype(np.float32)).to(card)

    def dec2(run):
        with torch.inference_mode():
            return capture_dec2(model, lambda: run(x * m, m))[1]

    before = dec2(model)
    planes = model.enc4.packed_weight()
    sd = model.state_dict()
    sd["enc4.input_conv.weight"] = sd["enc4.input_conv.weight"] * -2.0
    model.load_state_dict(sd)
    assert model.enc4.packed_weight() is not planes
    after, want = dec2(model), dec2(model.forward_plain)
    assert not np.array_equal(after, before)
    assert nrmse(after, want) <= FEAT_NRMSE_TOL


@pytest.mark.parametrize("edit", ["mul_", "copy_"])
def test_kernel_path_follows_an_edit_through_data(card, edit):
    # an in-place write through .data moves no version counter: planes cached
    # on it went stale, and K2 ran the old weights while the plain path ran the new
    model = init_generator(16, torch.Generator().manual_seed(9), card)
    g = np.random.default_rng(10)
    x = torch.from_numpy(g.random((2, 64, 64, 1), dtype=np.float32)).to(card)
    m = torch.from_numpy((g.random((2, 64, 64, 1)) > 0.3).astype(np.float32)).to(card)

    def dec2(run):
        with torch.inference_mode():
            return capture_dec2(model, lambda: run(x * m, m))[1]

    before = dec2(model)
    for name in ("enc4", "dec3"):
        w = getattr(model, name).input_conv.weight
        if edit == "mul_":
            w.data.mul_(-2.0)
        else:
            w.data.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(11)) * 0.05)
    packs = pack_pconv_weights.launches
    after, want = dec2(model), dec2(model.forward_plain)
    assert pack_pconv_weights.launches == packs + 1  # all 14 stages in one launch
    assert not np.array_equal(after, before)
    assert nrmse(after, want) <= FEAT_NRMSE_TOL


def test_pack_kernel_gives_the_plain_planes(card):
    model = init_generator(16, torch.Generator().manual_seed(12), card)
    weights = [p for n, p in model.named_parameters() if n.endswith("input_conv.weight")]
    g = torch.Generator().manual_seed(13)
    odd = torch.randn((5, 3, 2, 2), generator=g) * torch.exp(torch.randn((5, 3, 2, 2), generator=g) * 8)
    odd[0, 0, 0, 0], odd[1, 1, 1, 1] = float("inf"), float("nan")
    weights += [odd.to(card), torch.randn((4, 7, 1, 1), generator=g).to(card),
                torch.randn((3, 1, 3, 3), generator=g).to(card)]  # 17 weights: two launches
    before = pack_pconv_weights.launches
    with torch.no_grad():
        got = pack_pconv_weights(weights)
    assert pack_pconv_weights.launches == before + 2
    for w, (hi, lo) in zip(weights, got):
        want_hi, want_lo = pack_pconv_weight(w)
        assert hi.data_ptr() % 16 == 0 and lo.data_ptr() % 16 == 0
        assert torch.equal(torch.isnan(hi), torch.isnan(want_hi))
        assert torch.equal(hi.nan_to_num(), want_hi.nan_to_num())
        assert torch.equal(lo, want_lo)


def test_pconv_kernel_rejects_what_it_does_not_take(card):
    args, _ = stage_args(0, 8, 8, 0, 6, 3, 1, card)  # Cout % 4 != 0
    with pytest.raises(ValueError, match="outside the kernel"):
        fused_pconv_eval(*args)
    args, _ = stage_args(0, 8, 8, 0, 8, 3, 1, card)
    args[0] = args[0].double()
    with pytest.raises(ValueError, match="float32"):
        fused_pconv_eval(*args)


# enc1's one-channel variant (mma_c1): k = 7, stride 2, at the batches of
# the model's paths and at 512^2, an odd size and two small ones; then every
# k at stride 1 and 2 at 64^2 and 13^2
C1_CASES = ([(b, hw, 7, 2) for b in (1, 2, 8) for hw in (512, 511, 64, 13)]
            + [(2, hw, k, s) for hw in (64, 13) for k in range(1, 8) for s in (1, 2)])


def k2_used(before: dict, wrapper=fused_pconv_eval) -> dict:
    return {v: n - before[v] for v, n in wrapper.variants.items()}


@pytest.mark.parametrize("b,hw,k,s", C1_CASES, ids=[f"b{b}-{hw}-k{k}-s{s}" for b, hw, k, s in C1_CASES])
def test_c1_variant_matches_plain_and_repeats_bitwise(card, b, hw, k, s):
    args, _ = stage_args(b * 1000 + hw + 10 * k + s, hw, 1, 0, 64, k, s, card, b=b)
    assert plan_of(args, None).variant == "mma_c1"
    before, weight = dict(fused_pconv_eval.variants), args[2].clone()
    got, got_m = fused_pconv_eval(*args)
    again, again_m = fused_pconv_eval(*args, packed=pack_pconv_weight(args[2]))
    want, want_m = fused_pconv_eval_plain(*args)
    torch.cuda.synchronize()
    assert k2_used(before) == {**dict.fromkeys(K2_VARIANTS, 0), "mma_c1": 2}
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(got_m, want_m)
    assert torch.equal(got, again) and torch.equal(got_m, again_m)
    assert torch.equal(args[2], weight)  # the weight is read, not copied or changed


@pytest.mark.parametrize("holes", ["all", "none", "random", "nan"])
@pytest.mark.parametrize("cout", [64, 16, 8])
def test_c1_variant_masks_and_nan(card, holes, cout):
    args, _ = stage_args(cout + len(holes), 64, 1, 0, cout, 7, 2, card)
    x, m = args[0], args[1]
    if holes == "all":
        m.zero_()
    elif holes == "none":
        m.fill_(1.0)
    elif holes == "nan":  # NaN under a zero mask: x * m is NaN, and so is every window over it
        x[0, 40, 41, 0], m[0, 40, 41, 0] = float("nan"), 0.0
    got, got_m = fused_pconv_eval(*args)
    nan_out = mask_window_sum(torch.isnan(x).float(), 7, 7, 2, 3) > 0
    clean = list(args)
    clean[0] = torch.nan_to_num(x, nan=0.0)  # the same x * m wherever it is not NaN
    want, want_m = fused_pconv_eval_plain(*clean)
    torch.cuda.synchronize()
    assert torch.equal(got_m, want_m)
    assert torch.equal(torch.isnan(got), nan_out.expand_as(got))
    ok = ~torch.isnan(got)
    np.testing.assert_allclose(got[ok].cpu().numpy(), want[ok].cpu().numpy(), rtol=RTOL, atol=ATOL)
    assert (holes != "nan") or nan_out.sum().item() == 12  # 3 x 4 windows hold (40, 41)
    if holes == "all":
        assert not got_m.any()
    if holes == "none":
        assert got_m.all()


def test_eval_forward_runs_enc1_on_the_one_channel_variant(card):
    model = init_generator(64, torch.Generator().manual_seed(14), card)
    g = torch.Generator().manual_seed(15)
    x = torch.rand((2, 64, 64, 1), generator=g).to(card)
    m = (torch.rand((2, 64, 64, 1), generator=g) > 0.3).float().to(card)
    before, launches = dict(fused_pconv_eval.variants), fused_pconv_eval.launches
    with torch.inference_mode():
        model(x * m, m)
    used = k2_used(before)
    assert fused_pconv_eval.launches - launches == 13
    assert used["mma_c1"] == 1 and used["simt"] == 0
    assert used["mma"] + used["mma_split"] == 12 and used["split_reduce"] == used["mma_split"]


def test_c1_variant_rejects_what_it_does_not_take(card):
    args, _ = stage_args(0, 16, 1, 0, 8, 7, 2, card)
    with pytest.raises(ValueError, match="w_hi has shape"):
        fused_pconv_eval(*args, packed=pack_pconv_weight(torch.zeros((8, 1, 5, 5), device=card)))
    x = torch.empty(1 + 2 * 16 * 16, device=card)[1:].view(2, 16, 16, 1)
    args[0] = x.copy_(args[0])
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_pconv_eval(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 4, 512), (1, 16, 24, 8), (2, 32, 32, 64)])
def test_upsample_kernel_matches_plain(card, dtype, shape):
    x = torch.rand(shape, generator=torch.Generator().manual_seed(1)).to(card, dtype)
    got = upsample2x_fwd(x)
    want = upsample2x_fwd_plain(x.float())
    torch.cuda.synchronize()
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8  # 1 bf16 ulp below 1
    assert got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= tol


def test_upsample_forward_gives_torchs_bits_at_decoder_shapes(card):
    gen = torch.Generator().manual_seed(2)
    for h, c in DECODER_SHAPES:
        x = torch.randn((2, h, h, c), generator=gen).to(card)
        assert torch.equal(upsample2x_fwd(x), upsample2x_fwd_plain(x)), (h, c)


def test_upsample_kernels_count_no_launch_for_an_empty_batch(card):
    f0, b0 = upsample2x_fwd.launches, upsample2x_bwd.launches
    assert upsample2x_fwd(torch.zeros((0, 4, 4, 8), device=card)).shape == (0, 8, 8, 8)
    assert upsample2x_bwd(torch.zeros((0, 8, 8, 8), device=card)).shape == (0, 4, 4, 8)
    assert (upsample2x_fwd.launches, upsample2x_bwd.launches) == (f0, b0)
    upsample2x_fwd(torch.zeros((1, 4, 4, 8), device=card))
    upsample2x_bwd(torch.zeros((1, 8, 8, 8), device=card))
    assert (upsample2x_fwd.launches, upsample2x_bwd.launches) == (f0 + 1, b0 + 1)


def test_upsample_kernel_rejects_channels_it_cannot_vectorise(card):
    with pytest.raises(ValueError, match="C % 4 == 0"):
        upsample2x_fwd(torch.zeros((1, 4, 4, 5), device=card))
    with pytest.raises(ValueError, match="C % 8 == 0"):
        upsample2x_fwd(torch.zeros((1, 4, 4, 12), device=card, dtype=torch.bfloat16))


def test_model_kernel_path_matches_plain_path(card):
    model = init_generator(16, torch.Generator().manual_seed(0), card)
    g = torch.Generator().manual_seed(1)
    imgs = (torch.rand((3, 128, 128, 1), generator=g) * 255).to(torch.uint8).numpy()
    masks = ((torch.rand((3, 128, 128, 1), generator=g) > 0.3) * 255).to(torch.uint8).numpy()
    fused_pconv_eval.launches = upsample2x_fwd.launches = fused_decoder_tail.launches = 0
    got, got_dec2 = capture_dec2(model, lambda: BatchedInpainter(model, card, chunk=2)(imgs, masks))
    launches = (fused_pconv_eval.launches, upsample2x_fwd.launches, fused_decoder_tail.launches)
    assert launches == (2 * 13, 2 * 6, 2)
    x = torch.from_numpy(imgs.astype(np.float32) / 255.0).to(card)
    m = torch.from_numpy((masks > 0).astype(np.float32)).to(card)
    with torch.inference_mode():
        want, want_dec2 = capture_dec2(model, lambda: model.forward_plain(x * m, m).cpu().numpy())
    assert nrmse(got, want) <= NRMSE_TOL
    # dec2's features carry the signal the composite's holes flatten
    assert nrmse(got_dec2, want_dec2) <= FEAT_NRMSE_TOL
    valid = masks > 0
    np.testing.assert_array_equal(got[valid], (imgs.astype(np.float32) / 255.0)[valid])


def test_evaluate_runs_a_card_model_through_the_kernels(card, tmp_path):
    from PIL import Image

    model = init_generator(16, torch.Generator().manual_seed(2), card)
    g = np.random.default_rng(3)
    img, mask = tmp_path / "t.png", tmp_path / "t_mask.png"
    Image.fromarray(g.integers(0, 256, (96, 96), dtype=np.uint8)).save(img)
    Image.fromarray(((g.random((96, 96)) > 0.3) * 255).astype(np.uint8)).save(mask)
    fused_pconv_eval.launches = upsample2x_fwd.launches = fused_decoder_tail.launches = 0
    out = evaluate(img, mask, model, tmp_path / "out.png")
    launches = (fused_pconv_eval.launches, upsample2x_fwd.launches, fused_decoder_tail.launches)
    assert launches == (13, 6, 1)
    assert next(model.parameters()).device == card  # the caller's model stays put
    assert Image.open(out).size == (OUTPUT_SIZE, OUTPUT_SIZE)


def test_raw_wrappers_raise_under_autograd(card):
    x = torch.rand((1, 4, 4, 8), device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="records no gradient"):
        upsample2x_fwd(x)
    args, _ = stage_args(0, 8, 8, 0, 8, 3, 1, card)
    args[2].requires_grad_(True)
    with pytest.raises(RuntimeError, match="records no gradient"):
        fused_pconv_eval(*args)
    with torch.no_grad():  # the eval forward's own mode
        fused_pconv_eval(*args)
        upsample2x_fwd(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_autograd_matches_plain_at_decoder_shapes(card, dtype):
    gen = torch.Generator().manual_seed(3)
    for h, c in DECODER_SHAPES:
        x = torch.rand((2, h, h, c), generator=gen).to(card, dtype).requires_grad_(True)
        g = torch.rand((2, 2 * h, 2 * h, c), generator=gen).to(card, dtype)
        f0, b0 = upsample2x_fwd.launches, upsample2x_bwd.launches
        Upsample2x.apply(x).backward(g)
        assert (upsample2x_fwd.launches - f0, upsample2x_bwd.launches - b0) == (1, 1)
        want = upsample2x_bwd_plain(g.float())
        err = (x.grad.float() - want).abs()
        if dtype == torch.float32:
            assert err.max().item() <= 1e-6 * want.abs().max().item(), (h, c)
        else:  # one rounding of a positive fp32 sum: half a bf16 ulp
            assert (err <= 2.0 ** -8 * want.abs()).all().item(), (h, c)


def test_upsample_backward_takes_a_strided_gradient(card):
    x = torch.rand((2, 8, 8, 16), device=card, requires_grad=True)
    g = torch.rand((2, 16, 16, 16), device=card).permute(0, 2, 1, 3)  # not contiguous
    Upsample2x.apply(x).backward(g)
    torch.testing.assert_close(x.grad, upsample2x_bwd_plain(g.contiguous()), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="C % 4 == 0"):
        upsample2x_bwd(torch.zeros((1, 8, 8, 6), device=card))


K1_BWD_REL_TOL = 1e-6  # of max|plain|: fp32 taps in another order, atomics in torch's
ADJOINT_TOL = 1e-6     # |<Ux,g> - <x,U^T g>| over sum|Ux * g|: fp32 rounding of both sides
# odd spatial sizes (N, H, W, C) at C >= 16, where torch takes its channels-last kernel
ODD_UPSAMPLE_SHAPES = [(1, 1, 1, 16), (2, 3, 5, 16), (1, 7, 9, 64), (3, 2, 33, 32), (1, 17, 3, 128)]


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value's magnitude (8 bits of mantissa)."""
    return torch.pow(2.0, torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_upsample_forward_gives_torchs_bits_at_every_decoder_batch(card, batch):
    gen = torch.Generator().manual_seed(10 + batch)
    for h, c in DECODER_SHAPES:
        x = torch.randn((batch, h, h, c), generator=gen).to(card)
        assert torch.equal(upsample2x_fwd(x), upsample2x_fwd_plain(x)), (batch, h, c)


@pytest.mark.parametrize("shape", ODD_UPSAMPLE_SHAPES)
def test_upsample_forward_gives_torchs_bits_at_odd_sizes(card, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(sum(shape))).to(card)
    assert torch.equal(upsample2x_fwd(x), upsample2x_fwd_plain(x))


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_upsample_bf16_within_one_ulp_at_decoder_shapes(card, direction):
    """bf16 storage, fp32 taps, one rounding: within 1 ulp of the fp32
    result of the same bf16 inputs (positive data: no cancellation)."""
    gen = torch.Generator().manual_seed(20)
    for h, c in DECODER_SHAPES:
        side = h if direction == "fwd" else 2 * h
        x = torch.rand((2, side, side, c), generator=gen).to(card, torch.bfloat16)
        kernel, plain = ((upsample2x_fwd, upsample2x_fwd_plain) if direction == "fwd"
                         else (upsample2x_bwd, upsample2x_bwd_plain))
        got, want = kernel(x), plain(x.float())
        assert got.dtype == torch.bfloat16
        assert ((got.float() - want).abs() <= bf16_ulp(want)).all().item(), (direction, h, c)


@pytest.mark.parametrize("value", [float("inf"), float("-inf"), float("nan")])
def test_upsample_forward_propagates_inf_and_nan_at_the_borders_as_torch(card, value):
    """The border's zero-weight taps are multiplied as torch multiplies
    them: an inf or NaN in the first or last row or column reaches the
    outputs it reaches in torch, NaN for NaN."""
    for shape in [(2, 8, 8, 16), (1, 5, 7, 64), (1, 2, 3, 16), (1, 1, 4, 16)]:
        n, h, w, c = shape
        for where in [(0, slice(None)), (h - 1, slice(None)), (slice(None), 0),
                      (slice(None), w - 1), (0, 0), (h - 1, w - 1)]:
            x = torch.rand(shape, generator=torch.Generator().manual_seed(3)).to(card)
            x[(0, *where, slice(0, c, 3))] = value
            torch.testing.assert_close(upsample2x_fwd(x), upsample2x_fwd_plain(x), rtol=0, atol=0,
                                       equal_nan=True)


@pytest.mark.parametrize("shape", [(2, h, h, c) for h, c in DECODER_SHAPES] + ODD_UPSAMPLE_SHAPES)
def test_upsample_backward_matches_torch_and_is_the_adjoint(card, shape):
    n, h, w, c = shape
    gen = torch.Generator().manual_seed(sum(shape) + 5)
    g = torch.randn((n, 2 * h, 2 * w, c), generator=gen).to(card)
    x = torch.randn(shape, generator=gen).to(card)
    got, want = upsample2x_bwd(g), upsample2x_bwd_plain(g)
    assert got.shape == shape
    assert (got - want).abs().max().item() <= K1_BWD_REL_TOL * want.abs().max().item()
    prod = upsample2x_fwd(x).double() * g.double()
    adj = abs(prod.sum().item() - (x.double() * got.double()).sum().item()) / prod.abs().sum().item()
    assert adj <= ADJOINT_TOL


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_upsample_splits_a_batch_beyond_int_range(card, direction):
    """Batch 128 of the 256^2 x 64 decoder input: 2^31 or more elements on
    the 2x side, so the plan's two launches, each within 32-bit indices."""
    from terra_gan_tpu_torch.ops.cuda.upsample_kernel import plan_upsample

    n, h, c = 128, 256, 64
    assert len(plan_upsample(direction, n, h, h, c, torch.float32).chunks) == 2
    side = h if direction == "fwd" else 2 * h
    src = torch.randn((n, side, side, c), generator=torch.Generator().manual_seed(6)).to(card)
    kernel, plain = ((upsample2x_fwd, upsample2x_fwd_plain) if direction == "fwd"
                     else (upsample2x_bwd, upsample2x_bwd_plain))
    before = kernel.launches
    got = kernel(src)
    assert kernel.launches - before == 2
    # torch's own kernels stop at 2^31 elements: the plain version by halves
    want = torch.cat([plain(src[: n // 2]), plain(src[n // 2 :])])
    if direction == "fwd":
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= K1_BWD_REL_TOL * want.abs().max().item()


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_upsample_takes_more_channel_groups_than_a_block(card, direction):
    """C = 2048 in fp32 is 512 groups of 4, two slices of a block's 256
    threads (the decoder's widest upsample at base width 256)."""
    from terra_gan_tpu_torch.ops.cuda.upsample_kernel import plan_upsample

    n, h, w, c = 2, 6, 5, 2048
    assert plan_upsample(direction, n, h, w, c, torch.float32).slices == 2
    gen = torch.Generator().manual_seed(8)
    if direction == "fwd":
        x = torch.randn((n, h, w, c), generator=gen).to(card)
        assert torch.equal(upsample2x_fwd(x), upsample2x_fwd_plain(x))
    else:
        g = torch.randn((n, 2 * h, 2 * w, c), generator=gen).to(card)
        got, want = upsample2x_bwd(g), upsample2x_bwd_plain(g)
        assert got.shape == (n, h, w, c)
        assert (got - want).abs().max().item() <= K1_BWD_REL_TOL * want.abs().max().item()


def graph_kernel_nodes(graph) -> int:
    """The kernel nodes of a captured, kept CUDA graph (libcuda)."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        assert cuda.cuGraphNodeGetType(node, ctypes.byref(kind)) == 0
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_upsample_call_is_one_kernel_node_in_a_graph(card, direction):
    kernel = upsample2x_fwd if direction == "fwd" else upsample2x_bwd
    src = torch.rand((8, 64, 64, 256) if direction == "fwd" else (8, 128, 128, 256), device=card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(src)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = kernel(src)
    assert graph_kernel_nodes(graph) == 1
    graph.instantiate()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, kernel(src))


def test_train_step_kernel_path_matches_plain_path(card):
    gen = torch.Generator().manual_seed(4)
    state = GANTrainState.create(init_generator(16, gen, card), init_discriminator(16, gen, card))
    vgg = init_vgg(gen, card)
    plain = copy.deepcopy(state)
    plain.generator.forward = plain.generator.forward_plain
    g = np.random.default_rng(5)
    x = g.random((2, 128, 128, 1), dtype=np.float32)
    m = (g.random((2, 128, 128, 1)) > 0.3).astype(np.float32)
    m[:, 32:80, 16:64] = 0
    batch = {"image": torch.from_numpy(x).to(card), "mask": torch.from_numpy(m).to(card)}
    step = make_train_step()
    counts = [f.launches for f in (fused_pconv_eval, upsample2x_fwd, upsample2x_bwd)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got = step(state, batch, vgg)
        counts = [f.launches - c for f, c in zip((fused_pconv_eval, upsample2x_fwd, upsample2x_bwd), counts)]
        want = step(plain, batch, vgg)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert counts == [0, 7, 7]
    for k, v in want.items():
        assert abs(got[k].item() - v.item()) <= 1e-5 * abs(v.item()), k
    lr = 2e-4  # Adam's first step is about lr * sign(grad): a sign flip moves 2 lr
    for mod, ref in ((state.generator, plain.generator), (state.discriminator, plain.discriminator)):
        for (n, a), b in zip(mod.state_dict().items(), ref.state_dict().values()):
            if a.is_floating_point():
                assert (a - b).abs().max().item() < 2.2 * lr, n


def model_stages(width: int, size: int):
    """(name, input side, Ca, Cb, stage module) of each PConv stage of a
    PConvUNet(width) at ``size``^2, in forward order."""
    model = PConvUNet(width)
    out = []
    for name in STAGES:
        st, n = getattr(model, name), int(name[3:])
        side = size >> (n - 1)
        cin = st.input_conv.in_channels
        # decN's skip is enc(N-1)'s output (the input for dec1): its width
        cb = 0 if name.startswith("enc") or n == 1 else getattr(model, f"enc{n - 1}").input_conv.out_channels
        out.append((name, side, cin - cb, cb, st))
    return out


@pytest.mark.parametrize("batch", [5, 16, 32])
def test_train_stage_matches_plain_at_the_models_stages(card, batch):
    """K2's train forward against the plain partial conv (NRMSE, new_mask
    equal) and the gradients through it against autograd's through the
    plain version, at the 14 stages of the full-width 512^2 model."""
    g = torch.Generator().manual_seed(batch)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, h, ca, cb, st in model_stages(64, 512):
            x = torch.rand((batch, h, h, ca), generator=g).to(card)
            xs = torch.rand((batch, h, h, cb), generator=g).to(card) if cb else None
            m = (torch.rand((batch, h, h, 1), generator=g) > 0.3).float()
            m[:, h // 4 : h // 2, h // 8 : h // 2] = 0
            m = m.to(card)
            conv = st.input_conv
            w = (torch.randn(conv.weight.shape, generator=g) / math.sqrt(conv.weight[0].numel()))
            bias = torch.randn(conv.out_channels, generator=g) * 0.1
            leaves = [t.to(card).requires_grad_(True) for t in (x, xs, w, bias) if t is not None]
            ref = [t.detach().clone().requires_grad_(True) for t in leaves]

            def run(stage, ts):
                x_, xs_, w_, b_ = ts if cb else (ts[0], None, *ts[1:])
                return stage(x_, m, w_, b_, st.stride, st.padding, x_skip=xs_)

            before = fused_pconv_train.launches
            got, got_m = run(fused_pconv_train, leaves)
            want, want_m = run(fused_pconv_train_plain, ref)
            assert fused_pconv_train.launches == before + 1
            assert nrmse(got.detach().cpu(), want.detach().cpu()) <= NRMSE_TOL, name
            assert torch.equal(got_m, want_m), name
            up = torch.randn(got.shape, generator=g).to(card)
            for a, b in zip(torch.autograd.grad(got, leaves, up), torch.autograd.grad(want, ref, up)):
                assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item(), name
            del got, want, leaves, ref, up
    finally:
        torch.backends.cudnn.deterministic = deterministic


def test_train_forward_runs_every_stage_on_k2(card):
    model = init_generator(16, torch.Generator().manual_seed(3), card).train()
    g = torch.Generator().manual_seed(4)
    x = torch.rand((2, 128, 128, 1), generator=g).to(card)
    m = (torch.rand((2, 128, 128, 1), generator=g) > 0.3).float().to(card)
    counters = (fused_pconv_train, fused_pconv_eval, pack_pconv_weights, upsample2x_fwd,
                fused_decoder_tail)
    before = [f.launches for f in counters]
    variants = dict(fused_pconv_train.variants)
    out = model(x * m, m)
    out.mean().backward()
    used = [f.launches - b for f, b in zip(counters, before)]
    assert used == [14, 0, 1, 7, 0]
    assert k2_used(variants, fused_pconv_train)["mma_c1"] == 1
    assert k2_used(variants, fused_pconv_train)["simt"] == 0
    assert all(p.grad is not None for n, p in model.named_parameters() if p.requires_grad)


def tail_args(seed, b, h, w, c, dev, skip=True, xm_mode="rand"):
    """K3's arguments drawn as tests/test_tail_kernel.py draws them: the
    logits spread over units, so an error in the tail reaches the output."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.random(shape, dtype=np.float32)  # noqa: E731
    n = lambda s, *shape: rng.normal(0, s, shape).astype(np.float32)  # noqa: E731
    xm = {"rand": (f(b, 2 * h, 2 * w, 1) > 0.25).astype(np.float32),
          "zeros": np.zeros((b, 2 * h, 2 * w, 1), np.float32),
          "ones": np.ones((b, 2 * h, 2 * w, 1), np.float32)}[xm_mode]
    args = [f(b, h, w, c), (f(b, h, w, 1) > 0.1).astype(np.float32), f(b, 2 * h, 2 * w, 1), xm,
            n(0.05, 3, 3, c, c), n(0.05, 3, 3, 1, c) if skip else None, n(0.01, c),
            f(c) + 0.5, n(0.01, c), n(0.01, c), f(c) + 0.5, n(0.05, 3, 3, c, 1),
            np.array([0.01], np.float32)]
    return [None if a is None else torch.from_numpy(a).to(dev) for a in args]


@pytest.mark.parametrize("b,h,w,c,skip,xm_mode", [
    (2, 16, 16, 8, True, "rand"),     # the JAX tests' size
    (2, 16, 16, 8, False, "zeros"),   # the model's one-input form
    (1, 9, 13, 16, True, "rand"),     # ragged 14x14 output tiles
    (3, 8, 8, 4, False, "ones"),
    (2, 11, 5, 4, True, "rand"),      # C = 4, half of one 8-channel chunk
    (1, 10, 10, 12, False, "rand"),   # C = 12: the last chunk half empty
    (1, 7, 7, 64, True, "zeros"),     # 2H = 14: exactly one output tile
    (1, 32, 24, 64, True, "rand"),    # the model's width
    (1, 256, 256, 64, False, "rand"),  # the model's shape: 512 is no multiple of 14
    (1, 256, 256, 64, True, "zeros"),
])
def test_tail_kernel_matches_plain(card, b, h, w, c, skip, xm_mode):
    args = tail_args(b + h + c, b, h, w, c, card, skip, xm_mode)
    before = fused_decoder_tail.launches
    got = fused_decoder_tail(*args)
    again = fused_decoder_tail(*args)
    want = fused_decoder_tail_plain(*args)
    torch.cuda.synchronize()
    assert fused_decoder_tail.launches == before + 2
    assert got.shape == want.shape == (b, 2 * h, 2 * w, 1)
    assert torch.equal(got, again)  # no atomics: the same bits every call
    assert (got - want).abs().max().item() <= ATOL  # fp32 sums in another order
    assert nrmse(got.cpu(), want.cpu()) <= NRMSE_TOL
    if xm_mode == "ones":
        assert torch.equal(got, args[2])


@pytest.mark.parametrize("skip", [False, True])
def test_tail_kernel_propagates_a_nan_as_plain_does(card, skip):
    args = tail_args(7, 1, 24, 24, 16, card, skip)
    d, dm, x, xm = args[:4]
    dm[:, 8:16, 8:16] = 0.0  # a hole of dec2's mask
    xm[:, 16:32, 16:32] = 0.0  # and of the input's
    d[0, 11, 12, 5] = float("nan")
    got = fused_decoder_tail(*args)
    want = fused_decoder_tail_plain(*args)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert nan.any() and not nan.all()
    assert torch.equal(torch.isnan(got), nan)
    assert (got[~nan] - want[~nan]).abs().max().item() <= ATOL


def test_tail_kernel_fits_two_blocks_an_sm(card):
    import ctypes

    from terra_gan_tpu_torch.ops.cuda._build import load_library

    smem, blocks, threads, tile = (ctypes.c_int() for _ in range(4))
    assert load_library().tg_decoder_tail_info(*(ctypes.byref(v) for v in (
        smem, blocks, threads, tile))) == 0
    assert threads.value == 256 and tile.value == 14
    assert blocks.value >= 2, (blocks.value, smem.value)


def test_tail_kernel_raises_on_what_it_does_not_take(card):
    args = tail_args(0, 1, 8, 8, 8, card)
    grad = [a.clone().requires_grad_(True) if i == 0 else a for i, a in enumerate(args)]
    with pytest.raises(RuntimeError, match="records no gradient"):
        fused_decoder_tail(*grad)
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(ValueError, match="float32"):
            fused_decoder_tail(args[0].to(dtype), *args[1:])
    strided = args[0].permute(0, 2, 1, 3)  # the same shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fused_decoder_tail(strided, *args[1:])
    odd = args[2][:, :15]  # not 2H
    with pytest.raises(ValueError, match="exact 2x"):
        fused_decoder_tail(args[0], args[1], odd, args[3][:, :15], *args[4:])
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_decoder_tail(*tail_args(0, 1, 8, 8, 6, card))
    with torch.no_grad():  # the eval forward's own mode
        fused_decoder_tail(*grad)


def test_tail_kernel_counts_no_launch_for_an_empty_batch(card):
    args = tail_args(1, 1, 8, 8, 8, card)
    empty = [a[:0] if i < 4 else a for i, a in enumerate(args)]
    before = fused_decoder_tail.launches
    assert fused_decoder_tail(*empty).shape == (0, 16, 16, 1)
    assert fused_decoder_tail.launches == before
    fused_decoder_tail(*args)
    assert fused_decoder_tail.launches == before + 1


def test_model_fused_tail_matches_the_unfused_path(card):
    model = init_generator(16, torch.Generator().manual_seed(5), card)
    g = np.random.default_rng(6)
    x = torch.from_numpy(g.random((2, 128, 128, 1), dtype=np.float32)).to(card)
    m = torch.from_numpy((g.random((2, 128, 128, 1)) > 0.3).astype(np.float32)).to(card)
    kernels = (fused_decoder_tail, fused_pconv_eval, upsample2x_fwd)

    def counted(run):
        before = [f.launches for f in kernels]
        out = run().cpu().numpy()
        return out, [f.launches - c for f, c in zip(kernels, before)]

    def unfused(x, m):
        h, hm = model.decode(x, m, fused_pconv_eval, upsample2x_bilinear)
        return model.tail_forward(h, hm, x, m, fused_pconv_eval, upsample2x_bilinear)

    with torch.inference_mode():
        got, counts = counted(lambda: model(x * m, m))
        want, unfused_counts = counted(lambda: unfused(x * m, m))
        plain = model.forward_plain(x * m, m).cpu().numpy()
        xo, mo = (x * m)[:, :127, :127].contiguous(), m[:, :127, :127].contiguous()
        odd, odd_counts = counted(lambda: model(xo, mo))  # enc1 rounds up: not 2x
    assert counts == [1, 13, 6] and unfused_counts == [0, 14, 7]
    assert nrmse(got, want) <= NRMSE_TOL
    assert nrmse(got, plain) <= NRMSE_TOL
    assert odd_counts == [0, 14, 7] and odd.shape == (2, 127, 127, 1)


@pytest.mark.parametrize("case", range(5))
def test_probe_kernel_matches_its_plain_version(card, case):
    # probe_mosaic's own inputs, then odd shapes: 3 leading dims, C and N
    # not multiples of the tiles, and a single row
    _, fn, np_args, _, _ = probe_cases(*probe_inputs())[case]
    g = np.random.default_rng(case)
    a = g.random((3, 5, 7, 33), dtype=np.float32)
    odd = {"probe_lane_reduce": (a, a[0, 0, 0]),
           "probe_matvec_dot": (a, g.random((33, 1), dtype=np.float32)),
           "probe_lane_concat_dot": (a, g.random((66, 37), dtype=np.float32)),
           "probe_mask_broadcast": (a, a[..., 0]), "probe_row_build": (a[:1],)}
    for args in (np_args, odd[fn.__name__]):
        ts = [torch.from_numpy(np.ascontiguousarray(x)).to(card) for x in args]
        before = fn.launches
        got = fn(*ts)
        want = PLAIN[fn](*ts)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.shape == want.shape
        if fn.__name__ in ("probe_mask_broadcast", "probe_row_build"):
            assert torch.equal(got, want)
        else:
            assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


# P2's and P4's inputs: the script's shapes, odd C over 3 leading dims, a
# single row, and a contiguous view at a 4-byte offset; vec4 takes neither
# C = 33 nor the offset view
P2_P4_CASES = {"script": (16, 64, 64), "odd": (3, 5, 7, 33), "row": (1, 64),
               "offset": (16, 64, 64)}


def p2_p4_args(fn, case: str, dev):
    g = torch.Generator().manual_seed(len(case))
    shape = P2_P4_CASES[case]
    skip = 1 if case == "offset" else 0  # floats before a's first, in one allocation
    a = torch.rand(skip + math.prod(shape), generator=g).to(dev)[skip:].view(shape)
    other = (torch.rand((shape[-1], 1), generator=g) if fn is probe_matvec_dot
             else torch.rand(shape[:-1], generator=g))
    return a, other.to(dev)


@pytest.mark.parametrize("case", list(P2_P4_CASES))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("fn", [probe_matvec_dot, probe_mask_broadcast],
                         ids=["p2", "p4"])
def test_p2_p4_variant_matches_its_plain_version(card, fn, variant, case):
    a, other = p2_p4_args(fn, case, card)
    runs = variant == "scalar" or (a.shape[-1] % 4 == 0 and a.data_ptr() % 16 == 0)
    assert plan_probe(fn.__name__, a, other)[0] == ("vec4" if case in ("script", "row")
                                                     else "scalar")
    before, by_variant = fn.launches, dict(fn.variants)
    if not runs:
        with pytest.raises(ValueError, match="vec4 needs"):
            fn(a, other, variant=variant)
        assert fn.launches == before and fn.variants == by_variant
        return
    got = fn(a, other, variant=variant)
    want = PLAIN[fn](a, other)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert fn.variants[variant] == by_variant[variant] + 1
    assert got.shape == want.shape
    if fn is probe_mask_broadcast:
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


# P1's and P3's inputs: the script's shapes, odd C (and P3's N = 37) over 3
# leading dims, a single row, a contiguous view at a 4-byte offset, and P3
# with k2 past the shared budget (K in chunks); vec4 takes neither C = 33
# nor the offset view
P1_P3_CASES = {"script": ((16, 64, 64), 64), "odd": ((3, 5, 7, 33), 37), "row": ((1, 64), 64),
               "offset": ((16, 64, 64), 64), "chunked": ((8, 64, 200), 200)}


def p1_p3_args(fn, case: str, dev):
    g = torch.Generator().manual_seed(len(case))
    shape, n = P1_P3_CASES[case]
    skip = 1 if case == "offset" else 0  # floats before a's first, in one allocation
    a = torch.rand(skip + math.prod(shape), generator=g).to(dev)[skip:].view(shape)
    other = (torch.rand(shape[-1], generator=g) if fn is probe_lane_reduce
             else torch.rand((2 * shape[-1], n), generator=g))
    return a, other.to(dev)


@pytest.mark.parametrize("case", list(P1_P3_CASES))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("fn", [probe_lane_reduce, probe_lane_concat_dot], ids=["p1", "p3"])
def test_p1_p3_variant_matches_its_plain_version(card, fn, variant, case):
    a, other = p1_p3_args(fn, case, card)
    vec4 = case in ("script", "row", "chunked")
    runs = variant == "scalar" or vec4
    plan = plan_probe(fn.__name__, a, other)
    assert plan[0] == ("vec4" if vec4 else "scalar")
    if fn is probe_lane_concat_dot:
        assert (plan[4] < a.shape[-1]) == (case == "chunked")  # the K chunk
    before, by_variant = fn.launches, dict(fn.variants)
    if not runs:
        with pytest.raises(ValueError, match="vec4 needs"):
            fn(a, other, variant=variant)
        assert fn.launches == before and fn.variants == by_variant
        return
    got = fn(a, other, variant=variant)
    want = PLAIN[fn](a, other)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert fn.variants[variant] == by_variant[variant] + 1
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


# P5's inputs: the script's shape, rows of 4-float multiples and not, a
# single row, one-dimensional, many blocks, and a view at a 4-byte offset
P5_CASES = {"script": (16, 64, 64), "odd": (3, 5, 7, 33), "row": (1, 64), "flat": (37,),
            "small": (5, 4), "wide": (300, 1000), "ragged": (7, 5, 6), "offset": (16, 64, 64)}


@pytest.mark.parametrize("case", list(P5_CASES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_p5_variant_equals_its_plain_version(card, variant, case):
    g = torch.Generator().manual_seed(len(case))
    shape = P5_CASES[case]
    skip = 1 if case == "offset" else 0
    a = torch.rand(skip + math.prod(shape), generator=g).to(card)[skip:].view(shape)
    vec4 = case in ("script", "row", "small", "wide")
    assert plan_probe("probe_row_build", a)[0] == ("vec4" if vec4 else "scalar")
    before, by_variant = probe_row_build.launches, dict(probe_row_build.variants)
    if variant == "vec4" and not vec4:
        with pytest.raises(ValueError, match="vec4 needs"):
            probe_row_build(a, variant=variant)
        assert probe_row_build.launches == before and probe_row_build.variants == by_variant
        return
    got = probe_row_build(a, variant=variant)
    want = PLAIN[probe_row_build](a)
    torch.cuda.synchronize()
    assert probe_row_build.launches == before + 1
    assert probe_row_build.variants[variant] == by_variant[variant] + 1
    assert torch.equal(got, want)


def test_probe_kernels_refuse_what_they_do_not_take(card):
    a = torch.rand((4, 8, 16), device=card)
    with pytest.raises(ValueError, match="float32"):
        probe_lane_reduce(a.double(), torch.rand(16, device=card).double())
    with pytest.raises(ValueError, match="contiguous"):
        probe_mask_broadcast(a.transpose(0, 1), torch.rand((8, 4), device=card))
    with pytest.raises(ValueError, match="k2"):
        probe_lane_concat_dot(a, torch.rand((16, 4), device=card))
    with pytest.raises(ValueError, match="needs k"):
        probe_lane_reduce(a, torch.rand(15, device=card))
    for fn, other in ((probe_lane_reduce, torch.rand(16, device=card)),
                      (probe_lane_concat_dot, torch.rand((32, 4), device=card))):
        with pytest.raises(ValueError, match="not one of"):
            fn(a, other, variant="wide")
    # P3's k2 rows are float4s only at N % 4 == 0
    with pytest.raises(ValueError, match="vec4 needs"):
        probe_lane_concat_dot(a, torch.rand((32, 5), device=card), variant="vec4")
    with pytest.raises(ValueError, match="not one of"):
        probe_row_build(a, variant="wide")


def test_doctor_passes_on_the_card(card, capsys):
    assert doctor.main([]) == 0
    out = capsys.readouterr().out
    assert "[FAIL" not in out and "[WARN" not in out
    assert out.count(" OK maxerr=") == 5


def ffc_args(seed, b, cl, cg, h, w, dev):
    g = torch.Generator().manual_seed(seed)
    shapes = [(b, cl, h, w), (b, cg, h, w), (b, cg, h, w), (cl, cl, 3, 3), (cl, cg, 3, 3),
              (cg, cl, 3, 3)]
    return [(torch.randn(s, generator=g) * (0.1 if i >= 3 else 1.0)).to(dev)  # weights * 0.1
            for i, s in enumerate(shapes)]


@pytest.mark.parametrize("b,cl,cg,h,w", [(2, 128, 384, 64, 64), (2, 8, 24, 13, 14),
                                         (1, 12, 20, 5, 70), (1, 4, 4, 2, 2)])
def test_ffc_local_kernel_matches_plain(card, b, cl, cg, h, w):
    """Against the plain version in float64: 3xTF32 sums in fp32 (about 1e-7);
    TF32 alone reads about 5e-5. Two calls are bitwise equal."""
    args = ffc_args(b + cl + h + w, b, cl, cg, h, w, card)
    launches = ffc_local.launches
    got = ffc_local_kernel(*args)
    assert ffc_local.launches == launches + 1
    want = ffc_local_plain(*(a.double() for a in args))
    for g, v in zip(got, want):
        assert nrmse(g.cpu(), v.cpu()) < 1e-6
    assert all(torch.equal(a, c) for a, c in zip(got, ffc_local_kernel(*args)))


def test_ffc_local_gradients_match_autograd_through_plain(card):
    args = ffc_args(7, 2, 16, 48, 16, 16, card)
    got_in = [a.clone().requires_grad_() for a in args]
    want_in = [a.clone().requires_grad_() for a in args]
    outs = ffc_local(*got_in)
    grads = [torch.randn_like(o) for o in outs]
    got = torch.autograd.grad(outs, got_in, grads)
    want = torch.autograd.grad(ffc_local_plain(*want_in), want_in, grads)
    for a, c in zip(got, want):
        assert float((a - c).norm() / c.norm()) < 1e-5


def test_lama_block_ffcs_launch_the_kernel_once_a_forward(card):
    G = FFCResNetGenerator(ngf=8, n_downsampling=3, n_blocks=2).to(card).train()
    x = torch.rand((2, 64, 64, 1), device=card)
    m = (torch.rand((2, 64, 64, 1), device=card) > 0.3).float()
    launches = ffc_local.launches
    G(x * m, m).mean().backward()
    assert ffc_local.launches - launches == 4  # 2 a block
    with pytest.raises(ValueError, match="multiples of 4"):
        ffc_local_kernel(*ffc_args(1, 1, 6, 24, 8, 8, card))
