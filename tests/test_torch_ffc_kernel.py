"""A block FFC's local and cross convolutions (``ops/cuda/ffc_kernel.py``) on the CPU.

The plain version against three ``nn.Conv2d(padding_mode="reflect")``
and the two sums in float64; ``FFCLocal``'s written backward by
``torch.autograd.gradcheck`` in float64; which FFCs of a generator take
``ffc_local`` (the blocks') and which keep ``nn.Conv2d`` (the 7x7 and
the downsamplings), with no launch on the CPU; the state dict's keys,
LaMa's as before, and a state saved by the generator loading into it;
and the wrapper raising on what the kernel does not take. The kernel
itself runs only on a card: ``tests/test_torch_cuda.py`` (``-m cuda``)
and ``chip_smoke.py``'s ffc phase hold it to the plain version there.
"""

from __future__ import annotations

import pytest
import torch
from torch import nn

from terra_gan_tpu_torch.models import lama
from terra_gan_tpu_torch.models.lama import FFC, FFCResNetGenerator
from terra_gan_tpu_torch.ops.cuda import ffc_kernel
from terra_gan_tpu_torch.ops.cuda.ffc_kernel import (
    FFCLocal,
    ffc_local,
    ffc_local_kernel,
    ffc_local_plain,
)
from torch_bench.drivers.lama_train import seeded_generator
from torch_bench.reference import lama as reference

SIZES = {"ngf": 8, "n_downsampling": 3, "n_blocks": 2, "ratio": 0.75}


def inputs(b, cl, cg, h, w, seed=0, dtype=torch.float64, nl=None, ng=None):
    """(x_l, x_g, s, w_l2l, w_g2l, w_l2g); nl, ng output channels (default cl, cg)."""
    g = torch.Generator().manual_seed(seed)
    nl, ng = nl or cl, ng or cg
    shapes = [(b, cl, h, w), (b, cg, h, w), (b, ng, h, w), (nl, cl, 3, 3), (nl, cg, 3, 3),
              (ng, cl, 3, 3)]
    return [torch.randn(s, generator=g, dtype=dtype) for s in shapes]


@pytest.mark.parametrize("b,cl,cg,h,w,nl,ng", [
    (2, 8, 24, 8, 8, 8, 24),      # the gradcheck's shape
    (1, 4, 12, 5, 7, 4, 12),      # odd sides
    (3, 16, 48, 6, 64, 16, 48),   # a full column tile of the kernel
    (2, 12, 4, 2, 2, 20, 8),      # the least sides reflect padding takes; other outputs
])
def test_plain_is_three_reflect_convs_and_the_sums(b, cl, cg, h, w, nl, ng):
    x_l, x_g, s, w_ll, w_gl, w_lg = inputs(b, cl, cg, h, w, nl=nl, ng=ng)
    convs = []
    for weight in (w_ll, w_gl, w_lg):
        conv = nn.Conv2d(weight.shape[1], weight.shape[0], 3, padding=1, bias=False,
                         padding_mode="reflect").double()
        conv.weight.data.copy_(weight)
        convs.append(conv)
    y_l, y_g = ffc_local_plain(x_l, x_g, s, w_ll, w_gl, w_lg)
    assert torch.equal(y_l, convs[0](x_l) + convs[1](x_g))
    assert torch.equal(y_g, convs[2](x_l) + s)


def test_ffc_local_gradcheck():
    args = [t.requires_grad_() for t in inputs(2, 8, 24, 8, 8, seed=1)]
    assert torch.autograd.gradcheck(FFCLocal.apply, args, eps=1e-6, atol=1e-7, rtol=1e-5,
                                    fast_mode=True)


@pytest.mark.parametrize("need", ["x_l", "x_g", "s", "weights"])
def test_ffc_local_gradients_of_a_part(need):
    """The backward skips what no input needs and gives what one does, as autograd
    through the plain version does."""
    args = inputs(2, 8, 24, 6, 6, seed=2)
    leaves = {"x_l": [0], "x_g": [1], "s": [2], "weights": [3, 4, 5]}[need]
    got_in = [a.clone().requires_grad_(i in leaves) for i, a in enumerate(args)]
    want_in = [a.clone().requires_grad_(i in leaves) for i, a in enumerate(args)]
    g = torch.Generator().manual_seed(3)
    grads = [torch.randn(t.shape, generator=g, dtype=torch.float64)
             for t in ffc_local_plain(*args)]
    got = torch.autograd.grad(ffc_local(*got_in), [got_in[i] for i in leaves], grads)
    outs = [(o, d) for o, d in zip(ffc_local_plain(*want_in), grads) if o.requires_grad]
    want = torch.autograd.grad([o for o, _ in outs], [want_in[i] for i in leaves],
                               [d for _, d in outs])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-12)


def test_block_ffcs_take_it_and_the_others_keep_conv2d(monkeypatch):
    G = FFCResNetGenerator(**SIZES).train()
    ffcs = {name: m for name, m in G.named_modules() if isinstance(m, FFC)}
    first = lama.FIRST_DOWN + SIZES["n_downsampling"]
    block = {name for name in ffcs if int(name.split(".")[1]) >= first}
    assert len(block) == 2 * SIZES["n_blocks"]
    assert {name for name, m in ffcs.items() if m.fused} == block
    calls, conv_calls = [], []

    def counting(*args):
        calls.append(args[0].shape)
        return ffc_local(*args)

    monkeypatch.setattr(lama, "ffc_local", counting)
    for name, m in ffcs.items():
        for conv in (m.convl2l, m.convg2l, m.convl2g):
            if conv is not None:
                conv.register_forward_hook(lambda mod, a, o, name=name: conv_calls.append(name))
    launches = ffc_local.launches
    g = torch.Generator().manual_seed(4)
    x = torch.rand(2, 64, 64, 1, generator=g)
    m = (torch.rand(2, 64, 64, 1, generator=g) > 0.3).float()
    G(x * m, m).mean().backward()
    assert len(calls) == 2 * SIZES["n_blocks"]  # one call a block FFC a forward
    assert set(conv_calls) == set(ffcs) - block  # the 7x7 and the downsamplings: nn.Conv2d
    assert ffc_local.launches == launches  # the plain version on the CPU: no launch
    for name in block:  # the parameters stay in the block's convolutions, with their gradients
        assert all(c.weight.grad is not None
                   for c in (ffcs[name].convl2l, ffcs[name].convg2l, ffcs[name].convl2g))


def test_state_dict_keys_stay_lamas_and_a_saved_state_loads():
    G = FFCResNetGenerator(**SIZES)
    spec = reference.generator_spec(**SIZES)
    assert list(G.state_dict()) == [k for k, _, _ in spec]
    state = seeded_generator(SIZES, 5, torch.device("cpu"))
    G.load_state_dict(state, strict=True)
    assert all(torch.equal(v, state[k]) for k, v in G.state_dict().items())
    assert isinstance(G.model[5].conv1.ffc.convl2g, nn.Conv2d)


@pytest.mark.parametrize("fault", ["odd_channels", "shape", "dtype", "strided", "side", "device"])
def test_the_kernel_raises_on_what_it_does_not_take(fault):
    args = inputs(2, 8, 24, 8, 8, dtype=torch.float32)
    ffc_kernel.check_args(*args)  # what it takes
    if fault == "odd_channels":
        args = inputs(2, 6, 24, 8, 8, dtype=torch.float32)
    elif fault == "shape":
        args[2] = args[2][:, :8]
    elif fault == "dtype":
        args[1] = args[1].double()
    elif fault == "strided":
        args[0] = args[0].transpose(2, 3)
    elif fault == "side":
        args = inputs(2, 8, 24, 1, 8, dtype=torch.float32)
    with pytest.raises(ValueError):
        if fault == "device":  # a tensor on the CPU never goes to the kernel
            ffc_local_kernel(*args)
        else:
            ffc_kernel.check_args(*args)


def test_no_plain_version_off_the_cpu():
    args = [t.to("meta") for t in inputs(1, 4, 4, 4, 4, dtype=torch.float32)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ffc_local(*args)
