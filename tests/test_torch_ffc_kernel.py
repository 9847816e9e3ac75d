"""A block FFC's local and cross convolutions (``ops/cuda/ffc_kernel.py``) on the CPU.

The plain version against three ``nn.Conv2d(padding_mode="reflect")``
and the two sums in float64; ``FFCLocal``'s written backward by
``torch.autograd.gradcheck`` in float64, and bit for bit autograd's
through the plain version in float32; the backward kernels' plain
versions (``ffc_local_dgrad_plain``, ``ffc_local_wgrad_plain``) against
autograd's adjoint in float64 at the reflect fold's corner cases, and
emulations of what the kernels do beyond them: the dgrad's border
values line by line, run by run, and its fold by ``fold_sum``'s order;
the wgrad's stages, splits and partial sums in the fragments' order
and their reduction; ``plan_wgrad`` filling the card at Big-LaMa's
batches; which FFCs of a generator take ``ffc_local`` (the blocks') and
which keep ``nn.Conv2d`` (the 7x7 and the downsamplings), with no
launch on the CPU; the state dict's keys, LaMa's as before, and a state
saved by the generator loading into it; and the wrappers raising on
what the kernels do not take. The kernels themselves run only on a
card: ``tests/test_torch_cuda.py`` (``-m cuda``) and ``chip_smoke.py``'s
ffc phase hold them to their plain versions there.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from terra_gan_tpu_torch.models import lama
from terra_gan_tpu_torch.models.lama import FFC, FFCResNetGenerator
from terra_gan_tpu_torch.ops.cuda import ffc_kernel
from terra_gan_tpu_torch.ops.cuda.ffc_kernel import (
    PAD,
    WGRAD_PIXELS,
    WGRAD_TILE,
    WGRAD_TILE_SUMS,
    FFCLocal,
    ffc_local,
    ffc_local_dgrad,
    ffc_local_dgrad_plain,
    ffc_local_kernel,
    ffc_local_plain,
    ffc_local_wgrad,
    ffc_local_wgrad_plain,
    plan_wgrad,
    rot,
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


# (b, h, w): batches 1-2; sides 2 (the least the kernels take), 3 (rows 1
# and H-2 the same), 5 and 8, square and not
BWD_SHAPES = [(1, 2, 2), (2, 3, 3), (1, 5, 8), (2, 8, 5), (2, 8, 8), (1, 3, 5), (2, 2, 8),
              (1, 8, 3)]
# (ca, cb, nl, ng): multiples of 4, Ca != Cb, the outputs other counts
BWD_CHANNELS = [(4, 12, 8, 16), (8, 4, 12, 4)]


def adjoint(args, grads):
    """autograd's gradients through ffc_local_plain, every argument."""
    leaves = [a.clone().requires_grad_() for a in args]
    return torch.autograd.grad(ffc_local_plain(*leaves), leaves, grads)


def bwd_case(b, h, w, ca, cb, nl, ng, seed, dtype=torch.float64):
    args = inputs(b, ca, cb, h, w, seed=seed, dtype=dtype, nl=nl, ng=ng)
    g = torch.Generator().manual_seed(seed + 100)
    grads = [torch.randn((b, c, h, w), generator=g, dtype=dtype) for c in (nl, ng)]
    return args, grads


@pytest.mark.parametrize("chans", BWD_CHANNELS)
@pytest.mark.parametrize("b,h,w", BWD_SHAPES)
def test_dgrad_plain_is_autograds_adjoint(b, h, w, chans):
    args, grads = bwd_case(b, h, w, *chans, seed=b + h + w)
    want = adjoint(args, grads)
    got = ffc_local_dgrad_plain(*grads, *args[3:])
    for a, c in zip(got, want[:2]):
        torch.testing.assert_close(a, c, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("chans", BWD_CHANNELS)
@pytest.mark.parametrize("b,h,w", BWD_SHAPES)
def test_wgrad_plain_is_autograds_adjoint(b, h, w, chans):
    args, grads = bwd_case(b, h, w, *chans, seed=2 * b + h + w)
    want = adjoint(args, grads)
    got = ffc_local_wgrad_plain(args[0], args[1], *grads)
    for a, c in zip(got, want[3:]):
        torch.testing.assert_close(a, c, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("b,h,w,chans", [(2, 8, 8, BWD_CHANNELS[0]), (1, 3, 5, BWD_CHANNELS[1]),
                                         (2, 13, 14, (8, 24, 8, 24))])
def test_cpu_backward_is_autograds_bit_for_bit(b, h, w, chans):
    """On the CPU FFCLocal's backward is today's: autograd's through the
    plain version, bit for bit in float32."""
    args, grads = bwd_case(b, h, w, *chans, seed=h * w, dtype=torch.float32)
    leaves = [a.clone().requires_grad_() for a in args]
    got = torch.autograd.grad(ffc_local(*leaves), leaves, grads)
    want = adjoint(args, grads)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


def border_index(py, px, h, w):
    """csrc/ffc_conv.cu's border_index."""
    if py == 0:
        return px
    if py == h + 1:
        return w + 2 + px
    return 2 * (w + 2) + (0 if px == 0 else h) + py - 1


def fold_sum(bd, y, x, h, w):
    """csrc/ffc_conv.cu's fold_sum over bd [..., groups, 2(w+2)+2h], in its
    order: each border value the sum of its groups' slices, in order."""
    pys = [y + 1, 0 if y == 1 else -1, h + 1 if y == h - 2 else -1]
    pxs = [x + 1, 0 if x == 1 else -1, w + 1 if x == w - 2 else -1]
    f = torch.zeros(bd.shape[:-2], dtype=bd.dtype)
    for i, py in enumerate(pys):
        for j, px in enumerate(pxs):
            if py >= 0 and px >= 0 and (i, j) != (0, 0):
                v = bd[..., border_index(py, px, h, w)]
                total = v[..., 0]
                for k in range(1, v.shape[-1]):
                    total = total + v[..., k]
                f = f + total
    return f


def border_values(g, wt, h, w, group, run=16):
    """ffc_dgrad_border_kernel: [B][C][groups][2(w+2)+2h]. g, wt: the input
    channels of the gradients and of nn.Conv2d's weights, concatenated; a
    slice a group of ``group`` of them. Each value over its line of g's
    frame (row 0, row h-1, column 0, column w-1) in runs of ``run``
    positions, the taps t = 0, 1, 2 at position - t."""
    b, c = g.shape[0], wt.shape[1]
    groups = -(-g.shape[1] // group)
    bd = torch.zeros((b, c, groups, 2 * (w + 2) + 2 * h), dtype=g.dtype)
    lines = [  # (g's line, the weights' taps (ky, kx) at t, positions, padded (py, px))
        (g[:, :, 0], lambda t: (0, t), range(w + 2), lambda q: (0, q)),
        (g[:, :, h - 1], lambda t: (2, t), range(w + 2), lambda q: (h + 1, q)),
        (g[:, :, :, 0], lambda t: (t, 0), range(1, h + 1), lambda q: (q, 0)),
        (g[:, :, :, w - 1], lambda t: (t, 2), range(1, h + 1), lambda q: (q, w + 1)),
    ]
    for k in range(groups):
        ns = slice(k * group, (k + 1) * group)
        for ln, tap, positions, padded in lines:
            positions = list(positions)
            for r0 in range(0, len(positions), run):
                for q in positions[r0:r0 + run]:
                    acc = torch.zeros((b, c), dtype=bd.dtype)
                    for t in range(3):
                        if 0 <= q - t < ln.shape[-1]:
                            acc = acc + ln[:, ns, q - t] @ wt[ns, :, tap(t)[0], tap(t)[1]]
                    bd[:, :, k, border_index(*padded(q), h, w)] = acc
    return bd


@pytest.mark.parametrize("chans", BWD_CHANNELS)
@pytest.mark.parametrize("b,h,w", BWD_SHAPES)
def test_dgrad_kernels_border_and_fold_are_the_adjoint(b, h, w, chans):
    """The dgrad as its kernels split it: dP's interior (the rotated weights
    over the gradients zero-padded by 1), the border kernel's values in
    slices a group of input channels, and the epilogue's fold_sum onto rows
    1, h-2 and columns 1, w-2."""
    args, grads = bwd_case(b, h, w, *chans, seed=3 * b + h + w)
    w_ll, w_gl, w_lg = args[3:]
    g_l, g_g = grads
    inner = lambda g, wt: F.conv2d(g, rot(wt), padding=1)  # noqa: E731
    group = 8  # the kernel's groups are 128 input channels; here 1 to 3 of them
    outs = [(inner(g_l, w_ll) + inner(g_g, w_lg),
             border_values(torch.cat([g_l, g_g], 1), torch.cat([w_ll, w_lg]), h, w, group)),
            (inner(g_l, w_gl), border_values(g_l, w_gl, h, w, group))]
    want = adjoint(args, grads)
    for (out, bd), ref in zip(outs, want[:2]):
        out = out.clone()
        for y in range(h):
            for x in range(w):
                if y in (1, h - 2) or x in (1, w - 2):
                    out[..., y, x] += fold_sum(bd, y, x, h, w)
        torch.testing.assert_close(out, ref, atol=1e-12, rtol=1e-12)


def wgrad_emulated(x_l, x_g, g_l, g_g, need, sms):
    """ffc_wgrad_kernel and its reduction: plan_wgrad's jobs (128 output by
    16 input channels by 9 taps) and splits of the stages (row segments of
    64 pixels, g zero past w), each split's sums kept apart in the kernel's
    fragment order (q = tap * 2 + m-tile, the thread, the fragment's
    element), then added in split order into nn.Conv2d's layout."""
    b, ca, h, w = x_l.shape
    cb, nl, ng = x_g.shape[1], g_l.shape[1], g_g.shape[1]
    jobs_n, splits, stages = plan_wgrad(b, h, w, ca, cb, nl, ng, need, sms)
    bm, bc = WGRAD_TILE
    ct = lambda c: -(-c // bc)  # noqa: E731
    prods = [(g_l, x_l, nl, ca), (g_l, x_g, nl, cb), (g_g, x_l, ng, ca)]
    jobs = [(i, n0, c0) for i, (g, x, n, c) in enumerate(prods) if need[i]
            for n0 in range(0, n, bm) for c0 in range(0, ct(c) * bc, bc)]
    assert len(jobs) == jobs_n
    tiles_x = -(-w // WGRAD_PIXELS)
    part = torch.zeros((jobs_n, splits, WGRAD_TILE_SUMS), dtype=x_l.dtype)
    outs = [torch.full((n, c, 3, 3), float("nan"), dtype=x_l.dtype) if need[i] else None
            for i, (g, x, n, c) in enumerate(prods)]
    tid = torch.arange(256)
    warp, lane = tid // 32, tid % 32
    for j, (i, n0, c0) in enumerate(jobs):
        g, x, n_all, c_all = prods[i]
        gp = F.pad(g, (0, tiles_x * WGRAD_PIXELS - w))  # pixels past w: g is 0
        xp = F.pad(F.pad(x, PAD, mode="reflect"), (0, tiles_x * WGRAD_PIXELS - w))
        gp = F.pad(gp, (0, 0, 0, 0, 0, bm))[:, n0:n0 + bm]  # channels past N: 0
        xp = F.pad(xp, (0, 0, 0, 0, 0, bc))[:, c0:c0 + bc]
        for sp in range(splits):
            k0, k1 = stages * sp // splits, stages * (sp + 1) // splits
            tile = torch.zeros((bm, bc, 3, 3), dtype=x_l.dtype)
            for k in range(k0, k1):
                bi, rem = divmod(k, h * tiles_x)
                y, xt = divmod(rem, tiles_x)
                cols = slice(xt * WGRAD_PIXELS, (xt + 1) * WGRAD_PIXELS)
                gk = gp[bi, :, y, cols]
                for ky in range(3):
                    for kx in range(3):
                        xs = xp[bi, :, y + ky, xt * WGRAD_PIXELS + kx:(xt + 1) * WGRAD_PIXELS + kx]
                        tile[:, :, ky, kx] += gk @ xs.T
            for q in range(18):
                tap, m = divmod(q, 2)
                for e4 in range(4):
                    nn_ = (warp % 4) * 32 + m * 16 + lane // 4 + 8 * (e4 // 2)
                    cc = (warp // 4) * 8 + 2 * (lane % 4) + e4 % 2
                    part[j, sp, (q * 256 + tid) * 4 + e4] = tile[nn_, cc, tap // 3, tap % 3]
    for j, (i, n0, c0) in enumerate(jobs):  # the reduction, element by element
        g, x, n_all, c_all = prods[i]
        e = torch.arange(WGRAD_TILE_SUMS)
        s = part[j, 0].clone()
        for sp in range(1, splits):
            s = s + part[j, sp]
        q, t_, e4 = e // 1024, (e // 4) % 256, e % 4
        wp, ln = t_ // 32, t_ % 32
        n = n0 + (wp % 4) * 32 + (q % 2) * 16 + ln // 4 + 8 * (e4 // 2)
        c = c0 + (wp // 4) * 8 + 2 * (ln % 4) + e4 % 2
        keep = (n < n_all) & (c < c_all)
        flat = outs[i].view(-1)
        idx = (n * c_all + c) * 9 + q // 2
        assert torch.isnan(flat[idx[keep]]).all()  # each element written once
        flat[idx[keep]] = s[keep]
    return outs, splits


@pytest.mark.parametrize("need", [(True, True, True), (False, True, False), (True, False, True)])
@pytest.mark.parametrize("b,h,w,chans,sms", [(2, 8, 8, (8, 24, 12, 16), 4),
                                             (1, 5, 70, (4, 20, 8, 132), 132),
                                             (2, 3, 3, (132, 4, 4, 8), 3)])
def test_wgrad_kernels_tiles_splits_and_reduction_are_the_adjoint(b, h, w, chans, sms, need):
    """plan_wgrad's splits cover every stage once; each output element is
    written once; ragged channel tiles, a second column segment and splits
    > 1 included."""
    args, grads = bwd_case(b, h, w, *chans, seed=5 * b + h + w)
    outs, splits = wgrad_emulated(args[0], args[1], *grads, need, sms)
    want = adjoint(args, grads)
    for on, got, ref in zip(need, outs, want[3:]):
        if on:
            torch.testing.assert_close(got, ref, atol=1e-12, rtol=1e-12)
        else:
            assert got is None


@pytest.mark.parametrize("batch", [16, 8, 5])
def test_plan_wgrad_fills_the_card_at_lamas_batches(batch):
    """At Big-LaMa's block shapes the splits put at least one block on each
    of 132 SMs and lose under 10 % to the last wave; every stage is in one
    split; half the SMs halve nothing."""
    jobs, splits, stages = plan_wgrad(batch, 64, 64, 128, 384, 128, 384, (1, 1, 1), 132)
    assert jobs == 56 and stages == batch * 64
    assert jobs * splits >= 132
    waves = -(-jobs * splits // 132)
    assert jobs * splits / (132 * waves) > 0.9
    cover = [k for s in range(splits) for k in range(stages * s // splits,
                                                     stages * (s + 1) // splits)]
    assert cover == list(range(stages))
    assert plan_wgrad(batch, 64, 64, 128, 384, 128, 384, (1, 1, 1), 132) == (jobs, splits, stages)
    assert plan_wgrad(1, 2, 2, 4, 4, 4, 4, (1, 1, 1), 132)[1] <= 2  # no more splits than stages


@pytest.mark.parametrize("fault", ["outputs", "dtype", "device", "strided"])
def test_the_backward_kernels_raise_on_what_they_do_not_take(fault):
    args, grads = bwd_case(2, 8, 8, 8, 24, 8, 24, seed=9, dtype=torch.float32)
    ffc_kernel.check_backward(*grads, *args[3:])  # what they take
    with pytest.raises(ValueError):
        if fault == "outputs":
            args, grads = bwd_case(2, 8, 8, 8, 24, 6, 24, seed=9, dtype=torch.float32)
            ffc_kernel.check_backward(*grads, *args[3:])
        elif fault == "dtype":
            ffc_kernel.check_backward(grads[0].double(), grads[1], *args[3:])
        elif fault == "strided":
            ffc_kernel.check_backward(grads[0].transpose(2, 3), grads[1], *args[3:])
        else:  # a tensor on the CPU never goes to a kernel
            ffc_local_dgrad(*grads, *args[3:])
    if fault == "device":
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            ffc_local_wgrad(args[0], args[1], *grads)


def test_the_backward_opens_its_range_under_a_profiler():
    """tg.ffc_local_bwd once a block FFC's backward, under a profiler alone."""
    G = FFCResNetGenerator(**SIZES).train()
    g = torch.Generator().manual_seed(6)
    x = torch.rand(1, 64, 64, 1, generator=g)
    m = (torch.rand(1, 64, 64, 1, generator=g) > 0.3).float()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        G(x * m, m).mean().backward()
    names = [e.name for e in prof.events()]
    assert names.count("tg.ffc_local_bwd") == names.count("tg.ffc_local") == 2 * SIZES["n_blocks"]
    assert ffc_kernel.span("tg.ffc_local_bwd") is ffc_kernel.span("tg.other")  # no profiler: null
