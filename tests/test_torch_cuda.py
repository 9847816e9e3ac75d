"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so it also runs where JAX is
not installed; there, skip the JAX-forcing conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from terra_gan_tpu_torch.ops.cuda.pconv_kernel import (
    fold_batch_norm,
    fused_pconv_eval,
    fused_pconv_eval_plain,
)
from terra_gan_tpu_torch.ops.cuda.upsample_kernel import (
    Upsample2x,
    upsample2x_bwd,
    upsample2x_bwd_plain,
    upsample2x_fwd,
    upsample2x_fwd_plain,
)
from terra_gan_tpu_torch.ops.cuda.tail_kernel import fused_decoder_tail, fused_decoder_tail_plain
from terra_gan_tpu_torch.ops.resize import upsample2x_bilinear
from terra_gan_tpu_torch.cli import doctor
from terra_gan_tpu_torch.cli.probe_cuda import probe_cases, probe_inputs
from terra_gan_tpu_torch.evaluation.inference import OUTPUT_SIZE, evaluate
from terra_gan_tpu_torch.ops.cuda.probe_kernels import (
    PLAIN,
    probe_lane_concat_dot,
    probe_lane_reduce,
    probe_mask_broadcast,
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


def stage_args(seed, hw, ca, cb, cout, k, s, dev):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((2, hw, hw, ca), generator=g)
    xs = torch.rand((2, hw, hw, cb), generator=g) if cb else None
    m = (torch.rand((2, hw, hw, 1), generator=g) > 0.4).float()
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
     (3, 1, 32, 32, 32, 1)],
)
def test_pconv_kernel_matches_plain(card, k, s, ca, cb, cout, hw):
    args, skip = stage_args(k + ca + hw, hw, ca, cb, cout, k, s, card)
    before = fused_pconv_eval.launches
    got, got_m = fused_pconv_eval(*args, x_skip=skip)
    want, want_m = fused_pconv_eval_plain(*args, x_skip=skip)
    torch.cuda.synchronize()
    assert fused_pconv_eval.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(got_m, want_m)


def test_pconv_kernel_rejects_what_it_does_not_take(card):
    args, _ = stage_args(0, 8, 8, 0, 6, 3, 1, card)  # Cout % 4 != 0
    with pytest.raises(ValueError, match="outside the kernel"):
        fused_pconv_eval(*args)
    args, _ = stage_args(0, 8, 8, 0, 8, 3, 1, card)
    args[0] = args[0].double()
    with pytest.raises(ValueError, match="float32"):
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
    (1, 9, 13, 16, True, "rand"),     # ragged 16x16 output tiles
    (3, 8, 8, 4, False, "ones"),
    (1, 32, 24, 64, True, "rand"),    # the model's width
    (1, 256, 256, 64, False, "rand"),  # the model's shape
])
def test_tail_kernel_matches_plain(card, b, h, w, c, skip, xm_mode):
    args = tail_args(b + h + c, b, h, w, c, card, skip, xm_mode)
    before = fused_decoder_tail.launches
    got = fused_decoder_tail(*args)
    want = fused_decoder_tail_plain(*args)
    torch.cuda.synchronize()
    assert fused_decoder_tail.launches == before + 1
    assert got.shape == want.shape == (b, 2 * h, 2 * w, 1)
    assert (got - want).abs().max().item() <= ATOL  # fp32 sums in another order
    assert nrmse(got.cpu(), want.cpu()) <= NRMSE_TOL
    if xm_mode == "ones":
        assert torch.equal(got, args[2])


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


def test_probe_kernels_refuse_what_they_do_not_take(card):
    a = torch.rand((4, 8, 16), device=card)
    with pytest.raises(ValueError, match="float32"):
        probe_lane_reduce(a.double(), torch.rand(16, device=card).double())
    with pytest.raises(ValueError, match="contiguous"):
        probe_mask_broadcast(a.transpose(0, 1), torch.rand((8, 4), device=card))
    with pytest.raises(ValueError, match="k2"):
        probe_lane_concat_dot(a, torch.rand((16, 4), device=card))


def test_doctor_passes_on_the_card(card, capsys):
    assert doctor.main([]) == 0
    out = capsys.readouterr().out
    assert "[FAIL" not in out and "[WARN" not in out
    assert out.count(" OK maxerr=") == 5
