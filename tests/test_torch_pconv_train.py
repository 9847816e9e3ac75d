"""The train-mode PConv stage (``PConvTrain``, ``fused_pconv_train``) on the CPU.

Its backward is written out (the adjoint autograd takes through
``ops.pconv.partial_conv2d_split``), so it is held in f64 to finite
differences (``gradcheck``) and to autograd through the plain version,
for each class of stage the generator has; and the generator in train
mode, whose stages now run through it, to the plain path. On a card the
forward is K2's train variant: tests/test_torch_cuda.py holds that.
"""

from __future__ import annotations

import copy

import pytest
import torch

from terra_gan_tpu_torch.models.generator import PConv2d, PConvUNet
from terra_gan_tpu_torch.ops.cuda.pconv_kernel import (
    PConvTrain,
    fused_pconv_eval,
    fused_pconv_eval_plain,
    fused_pconv_train,
    fused_pconv_train_plain,
)

# (Ca, Cb, Cout, k, stride): the generator's stage classes
STAGES = {
    "enc1": (1, 0, 4, 7, 2),   # one input channel at k7 stride 2
    "enc2": (3, 0, 4, 5, 2),   # k5 stride 2
    "enc4": (4, 0, 8, 3, 2),   # k3 stride 2
    "dec3": (4, 3, 4, 3, 1),   # a decoder's (up, skip) pair
    "dec1": (4, 0, 4, 3, 1),   # dec1: the upsampled features alone
}


def stage_inputs(name: str, dtype=torch.float64, b: int = 2, hw: int = 9, seed: int = 0):
    ca, cb, cout, k, s = STAGES[name]
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((b, hw, hw, ca), generator=g, dtype=dtype)
    xs = torch.rand((b, hw, hw, cb), generator=g, dtype=dtype) if cb else None
    m = (torch.rand((b, hw, hw, 1), generator=g) > 0.35).to(dtype)
    m[:, 2:6, 3:7] = 0  # a hole wider than k3's window: some outputs see no valid pixel
    w = torch.randn((cout, ca + cb, k, k), generator=g, dtype=dtype) * 0.2
    bias = torch.randn(cout, generator=g, dtype=dtype) * 0.1
    return x, xs, m, w, bias, s, k // 2


@pytest.mark.parametrize("name", list(STAGES))
def test_train_function_passes_gradcheck_in_f64(name):
    x, xs, m, w, bias, s, p = stage_inputs(name)
    leaves = [t.requires_grad_(True) for t in (x, xs, w, bias) if t is not None]

    def stage(*ts):
        x_, xs_, w_, b_ = ts if xs is not None else (ts[0], None, *ts[1:])
        return PConvTrain.apply(x_, xs_, m, w_, b_, s, p, None)[0]

    assert torch.autograd.gradcheck(stage, tuple(leaves))


@pytest.mark.parametrize("name", list(STAGES))
def test_train_function_backward_is_autograds_through_the_plain_stage(name):
    x, xs, m, w, bias, s, p = stage_inputs(name, seed=1)
    leaves = [t.requires_grad_(True) for t in (x, xs, w, bias) if t is not None]
    out, new_mask = PConvTrain.apply(x, xs, m, w, bias, s, p, None)
    want, want_mask = fused_pconv_train_plain(x, m, w, bias, s, p, x_skip=xs)
    assert torch.equal(out, want) and torch.equal(new_mask, want_mask)
    assert not new_mask.requires_grad
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2), dtype=out.dtype)
    got = torch.autograd.grad(out, leaves, g)
    expect = torch.autograd.grad(want, leaves, g)
    for a, b in zip(got, expect):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", ["enc1", "dec3"])
def test_train_function_computes_only_the_gradients_asked_for(name):
    # enc1's input is real * mask, which needs no gradient: autograd asks
    # for the weight's and the bias's alone
    x, xs, m, w, bias, s, p = stage_inputs(name, dtype=torch.float32, seed=3)
    w.requires_grad_(True)
    out, _ = fused_pconv_train(x, m, w, bias, s, p, x_skip=xs)
    out.sum().backward()
    assert w.grad is not None and x.grad is None and bias.grad is None
    want = w.detach().clone().requires_grad_(True)
    fused_pconv_train_plain(x, m, want, bias, s, p, x_skip=xs)[0].sum().backward()
    assert torch.equal(w.grad, want.grad)


def test_cpu_train_stage_counts_no_launch():
    before = fused_pconv_train.launches, dict(fused_pconv_train.variants)
    x, xs, m, w, bias, s, p = stage_inputs("dec3", dtype=torch.float32)
    fused_pconv_train(x, m, w, bias, s, p, x_skip=xs)
    assert (fused_pconv_train.launches, fused_pconv_train.variants) == before


def test_each_eval_stage_names_its_train_stage():
    assert fused_pconv_eval.train is fused_pconv_train
    assert fused_pconv_eval_plain.train is fused_pconv_train_plain


def test_train_mode_pconv_takes_its_conv_from_the_stage():
    calls = []

    def stage(*a, **kw):
        raise AssertionError("train mode ran the eval stage")

    def train(x, mask, weight, bias, stride, padding, x_skip=None, packed=None):
        calls.append((x_skip is not None, packed))
        return fused_pconv_train_plain(x, mask, weight, bias, stride, padding, x_skip)

    stage.train = train
    layer = PConv2d(7, 4, 3, 1, 1).double().train()
    x, xs, m, _, _, _, _ = stage_inputs("dec3")
    out, new_mask = layer(x, m, skip=xs, stage=stage, packed="planes")
    assert calls == [(True, "planes")]
    assert out.shape == (2, 9, 9, 4) and (out >= 0).all()


@pytest.mark.parametrize("width,batch,hw", [(8, 2, 64), (8, 5, 32), (4, 3, 48)])
def test_generator_train_mode_gives_the_plain_paths_loss_and_gradients(width, batch, hw):
    torch.manual_seed(width + batch)
    model = PConvUNet(width).train()
    plain = copy.deepcopy(model)
    g = torch.Generator().manual_seed(hw)
    x = torch.rand((batch, hw, hw, 1), generator=g)
    m = (torch.rand((batch, hw, hw, 1), generator=g) > 0.3).float()
    m[:, hw // 4 : hw // 2, hw // 8 : hw // 2] = 0
    loss = (model(x * m, m) - x).square().mean()
    want = (plain.forward_plain(x * m, m) - x).square().mean()
    loss.backward()
    want.backward()
    assert torch.equal(loss, want)
    for (n, a), b in zip(model.named_parameters(), plain.parameters()):
        assert (a.grad is None) == (b.grad is None), n
        if a.grad is not None:
            assert torch.equal(a.grad, b.grad), n
    for (n, a), b in zip(model.named_buffers(), plain.buffers()):
        assert torch.equal(a, b), n
