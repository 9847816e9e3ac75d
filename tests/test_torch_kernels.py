"""The port's kernel modules (terra_gan_tpu_torch.ops.cuda) against the JAX kernels.

On the CPU each wrapper takes its plain version, so these tests hold
the plain versions to the JAX package's Pallas kernels, run as the JAX
tests run them (``interpret=True``), at small shapes. The CUDA kernels
themselves are held to their plain versions on a card by
tests/test_torch_cuda.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from terra_gan_tpu.ops import resize as jresize
from terra_gan_tpu.ops.pallas.pconv_kernel import fused_pconv_eval as jax_fused
from terra_gan_tpu.ops.pallas.upsample_kernel import (
    upsample2x_bwd_pallas,
    upsample2x_fwd_pallas,
)
from terra_gan_tpu.ops.pconv import partial_conv2d as jax_pconv
from terra_gan_tpu_torch.ops.cuda import _build
from terra_gan_tpu_torch.ops.cuda.pconv_kernel import (
    fold_batch_norm,
    fused_pconv_eval,
    fused_pconv_eval_plain,
)
from terra_gan_tpu_torch.ops.cuda.tail_kernel import fused_decoder_tail
from terra_gan_tpu_torch.ops.cuda.upsample_kernel import (
    Upsample2x,
    upsample2x_bwd,
    upsample2x_bwd_plain,
    upsample2x_fwd,
    upsample2x_fwd_plain,
)

RTOL, ATOL = 1e-4, 1e-5  # fp32 sums in another order (tests/test_pallas_kernel.py)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def oihw(w):
    """The JAX package's HWIO kernel as nn.Conv2d's weight."""
    return t(w.transpose(3, 2, 0, 1))


def stage_inputs(seed, hw, ca, cb, cout, k):
    rng = np.random.default_rng(seed)
    x = rng.random((2, hw, hw, ca), dtype=np.float32)
    xs = rng.random((2, hw, hw, cb), dtype=np.float32) if cb else None
    m = (rng.random((2, hw, hw, 1)) > 0.4).astype(np.float32)
    m[:, hw // 4 : hw // 2, hw // 4 : hw // 2] = 0
    w = (rng.standard_normal((k, k, ca + cb, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    bn = dict(
        bn_scale=rng.random(cout, dtype=np.float32) + 0.5,
        bn_bias=(rng.standard_normal(cout) * 0.1).astype(np.float32),
        bn_mean=(rng.standard_normal(cout) * 0.1).astype(np.float32),
        bn_var=rng.random(cout, dtype=np.float32) + 0.5,
    )
    return x, xs, m, w, b, bn


def port_stage(x, xs, m, w, b, bn, s, p):
    a, bb = fold_batch_norm(
        t(bn["bn_scale"]), t(bn["bn_bias"]), t(bn["bn_mean"]), t(bn["bn_var"])
    )
    return fused_pconv_eval(
        t(x), t(m), oihw(w), t(b), s, p, a, bb, x_skip=None if xs is None else t(xs)
    )


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
def test_pconv_plain_matches_pallas_kernel(k, s, ca, cb, cout, hw):
    x, xs, m, w, b, bn = stage_inputs(k * 100 + s + cb, hw, ca, cb, cout, k)
    xc = x if xs is None else np.concatenate([x, xs], -1)
    want, want_m = jax_fused(
        jnp.asarray(xc), jnp.asarray(m), jnp.asarray(w), jnp.asarray(b), s, k // 2,
        **{n: jnp.asarray(v) for n, v in bn.items()}, relu=True, interpret=True,
    )
    got, got_m = port_stage(x, xs, m, w, b, bn, s, k // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("hw", [64, 33])
def test_pconv_enc1_one_channel_matches_lax(hw):
    """enc1 (cin = 1, k7 s2): outside the Pallas kernel's envelope, so the
    JAX side is partial_conv2d followed by eval BatchNorm and ReLU."""
    x, _, m, w, b, bn = stage_inputs(hw, hw, 1, 0, 8, 7)
    out, want_m = jax_pconv(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(w), jnp.asarray(b), 2, 3,
        precision="highest",
    )
    inv = bn["bn_scale"] / np.sqrt(bn["bn_var"] + 1e-5)
    want = np.maximum((np.asarray(out) - bn["bn_mean"]) * inv + bn["bn_bias"], 0.0)
    got, got_m = port_stage(x, None, m, w, b, bn, 2, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 8, 8, 64), (3, 16, 24, 5)])
def test_upsample_plain_matches_pallas_kernel_and_resize(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    got = upsample2x_fwd(t(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(upsample2x_fwd_pallas(jnp.asarray(x), interpret=True)), atol=1e-5
    )
    np.testing.assert_allclose(
        got, np.asarray(jresize.upsample2x_bilinear(jnp.asarray(x))), atol=1e-5
    )


@pytest.mark.parametrize("shape", [(2, 8, 8, 8), (1, 4, 6, 4), (2, 1, 1, 16), (1, 2, 2, 8)])
def test_upsample_adjoint_plain_matches_pallas_kernel_and_jax_vjp(shape):
    """K1 bwd's plain version against the Pallas adjoint (interpret mode)
    and the JAX package's custom_vjp backward, fp32."""
    n, h, w, c = shape
    rng = np.random.default_rng(sum(shape) + 1)
    g = rng.standard_normal((n, 2 * h, 2 * w, c)).astype(np.float32)
    got = upsample2x_bwd(t(g)).numpy()
    want = np.asarray(upsample2x_bwd_pallas(jnp.asarray(g), interpret=True))
    x = jnp.zeros(shape, jnp.float32)
    (want_vjp,) = jax.vjp(jresize.upsample2x_bilinear, x)[1](jnp.asarray(g))
    for ref in (want, np.asarray(want_vjp)):
        assert got.shape == ref.shape == shape
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_upsample_autograd_function_passes_gradcheck_in_f64():
    x = torch.rand((2, 3, 5, 2), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(Upsample2x.apply, (x,))
    g = torch.rand((2, 6, 10, 2), dtype=torch.float64)
    (dx,) = torch.autograd.grad(Upsample2x.apply(x), x, g)
    assert torch.equal(dx, upsample2x_bwd_plain(g))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    fused_pconv_eval.launches = 0
    upsample2x_fwd.launches = 0
    upsample2x_bwd.launches = 0
    x, xs, m, w, b, bn = stage_inputs(0, 16, 8, 4, 8, 3)
    a, bb = fold_batch_norm(*(t(bn[n]) for n in ("bn_scale", "bn_bias", "bn_mean", "bn_var")))
    args = (t(x), t(m), oihw(w), t(b), 1, 1, a, bb)
    got, got_m = fused_pconv_eval(*args, x_skip=t(xs))
    want, want_m = fused_pconv_eval_plain(*args, x_skip=t(xs))
    assert torch.equal(got, want) and torch.equal(got_m, want_m)
    assert torch.equal(upsample2x_fwd(t(x)), upsample2x_fwd_plain(t(x)))
    assert torch.equal(upsample2x_bwd(t(x)), upsample2x_bwd_plain(t(x)))
    x = t(x).requires_grad_(True)  # the plain version records its graph on the CPU
    Upsample2x.apply(x).sum().backward()
    assert x.grad is not None
    assert fused_pconv_eval.launches == upsample2x_fwd.launches == upsample2x_bwd.launches == 0


def test_other_devices_raise_instead_of_falling_back():
    def meta(*shape):
        return torch.zeros(shape, device="meta")

    with pytest.raises(ValueError, match="no kernel"):
        upsample2x_fwd(meta(1, 4, 4, 8))
    with pytest.raises(ValueError, match="no kernel"):
        upsample2x_bwd(meta(1, 8, 8, 8))
    with pytest.raises(ValueError, match="no kernel"):
        fused_pconv_eval(
            meta(1, 4, 4, 8), meta(1, 4, 4, 1), meta(8, 8, 3, 3), meta(8),
            1, 1, meta(8), meta(8),
        )
    with pytest.raises(ValueError, match="no kernel"):
        fused_decoder_tail(
            meta(1, 4, 4, 8), meta(1, 4, 4, 1), meta(1, 8, 8, 1), meta(1, 8, 8, 1),
            meta(3, 3, 8, 8), None, meta(8), meta(8), meta(8), meta(8), meta(8),
            meta(3, 3, 8, 1), meta(1),
        )


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_sources_and_key():
    srcs, deps = _build._sources()
    assert {p.name for p in srcs} == {"decoder_tail.cu", "ffc_conv.cu", "pconv_eval.cu",
                                      "probes.cu", "upsample2x.cu"}
    key = _build._digest(srcs + deps)
    assert len(key) == 16 and key == _build._digest(srcs + deps)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
