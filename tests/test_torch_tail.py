"""K3, the fused decoder tail: the port's plain version against the JAX package.

On the CPU ``fused_decoder_tail`` takes its plain version, so these tests
hold that version to the JAX package's ``tail_reference`` and to its
Pallas kernel run as the JAX tests run it (``interpret=True``, fp32
compute), with the inputs of tests/test_tail_kernel.py drawn in numpy
(B = 2, H = 16, C = 8). The kernel itself is held to its plain version
on a card by tests/test_torch_cuda.py. Tolerance 1e-5 absolute on the
composite: fp32 sums taken in another order.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from terra_gan_tpu.models import PConvUNet as JaxPConvUNet
from terra_gan_tpu.ops.pallas.tail_kernel import fused_decoder_tail as jax_tail
from terra_gan_tpu.ops.pallas.tail_kernel import tail_reference
from terra_gan_tpu_torch.ops.cuda.pconv_kernel import fused_pconv_eval
from terra_gan_tpu_torch.ops.cuda.tail_kernel import fused_decoder_tail, fused_decoder_tail_plain
from terra_gan_tpu_torch.ops.resize import upsample2x_bilinear
from terra_gan_tpu_torch.utils.weights import generator_from_jax_variables, init_generator

ATOL = 1e-5
NRMSE_TOL = 1e-5
MASK_MODES = [("rand", "rand"), ("zeros", "ones"), ("zeros", "rand")]  # (xm, dm)


def nrmse(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.abs(b).max(), 1e-12))


def make_args(seed, b=2, h=16, c=8, xm_mode="rand", dm_mode="rand"):
    """numpy arrays in the order of the JAX signature, drawn as
    tests/test_tail_kernel.py draws them."""
    rng = np.random.default_rng(seed)
    d = rng.random((b, h, h, c), dtype=np.float32)
    dm = (np.ones((b, h, h, 1), np.float32) if dm_mode == "ones"
          else (rng.random((b, h, h, 1)) > 0.1).astype(np.float32))
    x = rng.random((b, 2 * h, 2 * h, 1), dtype=np.float32)
    xm = {"ones": np.ones((b, 2 * h, 2 * h, 1), np.float32),
          "zeros": np.zeros((b, 2 * h, 2 * h, 1), np.float32),
          "rand": (rng.random((b, 2 * h, 2 * h, 1)) > 0.25).astype(np.float32)}[xm_mode]
    k_main = rng.normal(0, 0.05, (3, 3, c, c)).astype(np.float32)
    k_skip = rng.normal(0, 0.05, (3, 3, 1, c)).astype(np.float32)
    bias = rng.normal(0, 0.01, (c,)).astype(np.float32)
    bn_s = rng.random(c, dtype=np.float32) + 0.5
    bn_b = rng.normal(0, 0.01, (c,)).astype(np.float32)
    bn_m = rng.normal(0, 0.01, (c,)).astype(np.float32)
    bn_v = rng.random(c, dtype=np.float32) + 0.5
    k_fin = rng.normal(0, 0.05, (3, 3, c, 1)).astype(np.float32)
    b_fin = np.asarray([0.01], np.float32)
    return [d, dm, x, xm, k_main, k_skip, bias, bn_s, bn_b, bn_m, bn_v, k_fin, b_fin]


def port(args, skip=True):
    t = [None if a is None else torch.from_numpy(np.array(a, copy=True)) for a in args]
    if not skip:
        t[5] = None
    return fused_decoder_tail(*t).numpy()


def jax_kernel(args):
    return np.asarray(jax_tail(*map(jnp.asarray, args), interpret=True, compute=jnp.float32))


@pytest.mark.parametrize("xm_mode,dm_mode", MASK_MODES)
def test_plain_matches_jax_with_skip(xm_mode, dm_mode):
    args = make_args(0, xm_mode=xm_mode, dm_mode=dm_mode)
    got = port(args)
    ref = np.asarray(tail_reference(*map(jnp.asarray, args)))
    assert got.shape == ref.shape == (2, 32, 32, 1)
    assert np.abs(got - ref).max() <= ATOL
    assert np.abs(got - jax_kernel(args)).max() <= ATOL


@pytest.mark.parametrize("xm_mode,dm_mode", MASK_MODES)
def test_one_input_form_is_the_jax_tail_with_a_zero_skip(xm_mode, dm_mode):
    args = make_args(1, xm_mode=xm_mode, dm_mode=dm_mode)
    got = port(args, skip=False)
    args[5] = np.zeros_like(args[5])
    assert np.abs(got - np.asarray(tail_reference(*map(jnp.asarray, args)))).max() <= ATOL
    assert np.abs(got - jax_kernel(args)).max() <= ATOL


def test_preserved_pixels_are_the_input_exactly():
    args = make_args(2, xm_mode="ones")
    for skip in (True, False):
        np.testing.assert_array_equal(port(args, skip), args[2])


def test_non_2x_geometry_raises():
    args = [torch.from_numpy(a) for a in make_args(3, b=1)]
    args[2], args[3] = args[2][:, :30], args[3][:, :30]  # 30 rows for H = 16
    for fn in (fused_decoder_tail, fused_decoder_tail_plain):
        with pytest.raises(ValueError, match="exact 2x"):
            fn(*args)


@pytest.fixture(scope="module")
def w8():
    g = JaxPConvUNet(base_width=8)
    z = jnp.zeros((1, 64, 64, 1))
    v = jax.jit(g.init, static_argnums=3)(jax.random.PRNGKey(2), z, z + 1, False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), v)
    rng = np.random.default_rng(2)
    for blk, stats in v["batch_stats"].items():
        c = stats["bn"]["mean"].shape[0]
        stats["bn"]["mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
        stats["bn"]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        v["params"][blk]["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        v["params"][blk]["bn"]["bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
    return g, v


def tiles(hw=64, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.random((2, hw, hw, 1), dtype=np.float32)
    m = (rng.random((2, hw, hw, 1)) > 0.3).astype(np.float32)
    m[:, hw // 8 : hw // 2, hw // 4 : 3 * hw // 4] = 0
    return x, m


def unfused(model, x, m):
    """The eval forward with the unfused tail, on the CPU's plain ops."""
    h, hm = model.decode(x, m, fused_pconv_eval, upsample2x_bilinear)
    return model.tail_forward(h, hm, x, m, fused_pconv_eval, upsample2x_bilinear)


def test_model_with_fused_tail_matches_jax_and_the_unfused_tail(w8):
    g, v = w8
    x, m = tiles()
    want = np.asarray(jax.jit(lambda v, a, b: g.apply(v, a * b, b, False))(v, x, m))
    model = generator_from_jax_variables(v, 8, "cpu")
    xt, mt = torch.from_numpy(x * m), torch.from_numpy(m)
    with torch.inference_mode():
        fused = model(xt, mt).numpy()
        plain = unfused(model, xt, mt).numpy()
    assert nrmse(fused, want) <= NRMSE_TOL
    np.testing.assert_array_equal(fused, plain)  # the same plain ops on the CPU


def tails_taken(model, x, m):
    """(fused, unfused) tail calls of one forward, and its output."""
    calls = {"fused": 0, "unfused": 0}
    for name, key in (("fused_tail_forward", "fused"), ("tail_forward", "unfused")):
        def counted(*a, _f=getattr(model, name), _k=key):
            calls[_k] += 1
            return _f(*a)
        setattr(model, name, counted)
    try:
        y = model(torch.from_numpy(x * m), torch.from_numpy(m))
    finally:
        del model.fused_tail_forward, model.tail_forward
    return (calls["fused"], calls["unfused"]), y


@pytest.mark.parametrize("hw,train,want", [
    (64, False, (1, 0)),   # eval at an exact 2x tail: K3's path
    (63, False, (0, 1)),   # enc1 rounds 63 up: the tail is not 2x
    (64, True, (0, 1)),    # train mode: K3 has no backward
])
def test_eval_forward_takes_the_fused_tail_at_2x_only(hw, train, want):
    model = init_generator(8, torch.Generator().manual_seed(9), "cpu").train(train)
    x, m = tiles(hw=hw, seed=9)
    with torch.inference_mode(not train):
        taken, y = tails_taken(model, x, m)
    assert taken == want and y.shape == (2, hw, hw, 1)


def test_train_mode_runs_the_unfused_tail():
    x, m = tiles(seed=5)
    out = {}
    for name in ("forward", "unfused"):
        model = init_generator(8, torch.Generator().manual_seed(6), "cpu").train()
        xt, mt = torch.from_numpy(x * m), torch.from_numpy(m)
        y = model(xt, mt) if name == "forward" else unfused(model, xt, mt)
        y.mean().backward()
        out[name] = (y.detach(), model.dec1.input_conv.weight.grad, model.final.weight.grad,
                     model.dec1.bn.running_mean.clone())
    for a, b in zip(out["forward"], out["unfused"]):
        assert torch.equal(a, b)


def test_odd_input_raises_with_the_fused_tail():
    model = init_generator(8, torch.Generator().manual_seed(7), "cpu")
    x, m = tiles(hw=63, seed=7)
    xt, mt = torch.from_numpy(x * m), torch.from_numpy(m)
    with torch.inference_mode():
        assert model(xt, mt).shape == (2, 63, 63, 1)  # the unfused tail crops and pads
        h, hm = model.decode(xt, mt, fused_pconv_eval, upsample2x_bilinear)
        with pytest.raises(ValueError, match="exact 2x"):
            model.fused_tail_forward(h, hm, xt, mt, fused_decoder_tail)


def test_cpu_runs_launch_no_kernel(w8):
    before = fused_decoder_tail.launches
    port(make_args(8))
    model = generator_from_jax_variables(w8[1], 8, "cpu")
    x, m = tiles(seed=8)
    with torch.inference_mode():
        model(torch.from_numpy(x * m), torch.from_numpy(m))
    assert fused_decoder_tail.launches == before
