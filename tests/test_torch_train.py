"""The port's loss modules and train and eval steps against the JAX package, in fp32.

Same inputs (numpy seeds) and the JAX package's weights carried across
(``utils.weights``) at width 8, 64^2, batch 2. Forwards are held to
NRMSE <= 1e-5 and loss components to 1e-6 relative (fp32 sums in
another order). A whole train step in fp32 is held only to the loose
bound of the JAX package's own torch test (losses within 2e-4,
tests/test_train_step.py:157-159): train-mode BatchNorm amplifies fp32
reassociation; the semantic gate is tests/test_torch_train_f64.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from terra_gan_tpu.losses import InpaintingLossConfig as JLossCfg
from terra_gan_tpu.losses import inpainting as jloss
from terra_gan_tpu.models import Discriminator as JD
from terra_gan_tpu.models import PConvUNet as JG
from terra_gan_tpu.models.vgg import random_weights, vgg16_features
from terra_gan_tpu.training.state import GANTrainState as JState
from terra_gan_tpu.training.state import adam as j_adam
from terra_gan_tpu.training.step import bce_with_logits as j_bce
from terra_gan_tpu.training.step import make_train_step as j_make_train_step
from terra_gan_tpu_torch.losses import (
    InpaintingLossConfig,
    boundary_aware_loss,
    boundary_band,
    inpainting_loss,
    l1_loss,
    total_variation_loss,
)
from terra_gan_tpu_torch.models.vgg import VGG16Features, vgg_state_from_torchvision
from terra_gan_tpu_torch.training.state import GANTrainState
from terra_gan_tpu_torch.training.step import (
    bce_with_logits,
    make_eval_step,
    make_train_step,
)
from terra_gan_tpu_torch.utils.weights import (
    discriminator_from_jax_variables,
    generator_from_jax_variables,
    init_discriminator,
    init_generator,
    init_vgg,
    vgg_from_jax_params,
)

NRMSE_TOL = 1e-5
LOSS_REL_TOL = 1e-6
WIDTH, HW = 8, 64


def nrmse(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.abs(b).max(), 1e-12))


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def batch_np(seed: int = 21, n: int = 2, hw: int = HW):
    rng = np.random.default_rng(seed)
    real = rng.random((n, hw, hw, 1), dtype=np.float32)
    mask = (rng.random((n, hw, hw, 1)) > 0.3).astype(np.float32)
    mask[:, hw // 4 : hw // 2 + 8, hw // 8 : hw // 2] = 0.0
    return real, mask


@pytest.fixture(scope="module")
def jax_vars():
    z = jnp.zeros((2, HW, HW, 1))
    gv = jax.jit(JG(base_width=WIDTH).init, static_argnums=3)(jax.random.PRNGKey(0), z, z + 1, False)
    dv = jax.jit(JD(base_width=WIDTH).init, static_argnums=2)(jax.random.PRNGKey(1), z, False)
    as_np = lambda tree: jax.tree.map(lambda a: np.array(a, copy=True), tree)  # noqa: E731
    vgg = [(np.asarray(k), np.asarray(b)) for k, b in random_weights(0)]
    return as_np(gv), as_np(dv), vgg


@pytest.mark.parametrize("train", [True, False])
def test_discriminator_matches_jax(jax_vars, train):
    _, dv, _ = jax_vars
    dv = jax.tree.map(np.copy, dv)
    rng = np.random.default_rng(3)
    for stats in dv["batch_stats"].values():  # eval mode reads the statistics
        stats["mean"] = rng.normal(0, 0.1, stats["mean"].shape).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 1.5, stats["var"].shape).astype(np.float32)
    x = np.random.default_rng(4).random((2, HW, HW, 1), dtype=np.float32)
    want, upd = JD(base_width=WIDTH).apply(dv, jnp.asarray(x), train, mutable=["batch_stats"])
    D = discriminator_from_jax_variables(dv, WIDTH, "cpu").train(train)
    with torch.no_grad():
        got = D(t(x))
    assert got.shape == want.shape == (2, HW // 16 - 1, HW // 16 - 1, 1)
    assert nrmse(got, want) <= NRMSE_TOL
    bn = D.model[3]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["block1_bn"]["mean"]),
                               rtol=1e-5, atol=1e-7)


def test_discriminator_parameter_order_is_the_references():
    from terra_gan_tpu.training.checkpoint import _disc_param_entries

    names = [n for n, _ in init_discriminator(8, torch.Generator().manual_seed(0), "cpu").named_parameters()]
    assert names == [n for n, _ in _disc_param_entries()] and len(names) == 16


def test_vgg_features_match_jax_and_load_torchvision_layouts(jax_vars):
    _, _, params = jax_vars
    x = np.random.default_rng(5).random((2, HW, HW, 1), dtype=np.float32)
    want = np.asarray(vgg16_features(jnp.asarray(x), params))
    vgg = vgg_from_jax_params(params, "cpu")
    with torch.no_grad():
        got = vgg(t(x))
    assert got.shape == want.shape == (2, HW // 4, HW // 4, 256)
    assert nrmse(got, want) <= NRMSE_TOL
    assert not any(p.requires_grad for p in vgg.parameters())
    full = {f"features.{k}": v for k, v in vgg.features.state_dict().items()}
    full["classifier.0.weight"] = torch.zeros(4, 4)  # a whole torchvision VGG16
    for sd in (full, vgg.features.state_dict()):
        other = VGG16Features()
        other.load_state_dict(vgg_state_from_torchvision(sd), strict=True)
        with torch.no_grad():
            assert torch.equal(other(t(x)), got)


def test_init_vgg_is_seeded_he_normal():
    a = init_vgg(torch.Generator().manual_seed(0), "cpu")
    b = init_vgg(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    w = a.features[14].weight
    assert abs(w.std().item() / np.sqrt(2.0 / (9 * 256)) - 1.0) < 0.05
    assert torch.equal(a.features[14].bias, torch.zeros(256))


def _loss_cases():
    real, mask = batch_np()
    pred = np.clip(real + np.random.default_rng(6).normal(0, 0.1, real.shape), 0, 1).astype(np.float32)
    return pred, real, mask


@pytest.mark.parametrize("name", ["l1", "tv", "band", "boundary"])
def test_loss_components_match_jax(name):
    pred, real, mask = _loss_cases()
    fns = {
        "l1": (lambda: l1_loss(t(pred), t(real)), lambda: jloss.l1_loss(pred, real)),
        "tv": (lambda: total_variation_loss(t(pred * (1 - mask))),
               lambda: jloss.total_variation_loss(pred * (1 - mask))),
        "band": (lambda: boundary_band(t(mask)), lambda: jloss.boundary_band(mask)),
        "boundary": (lambda: boundary_aware_loss(t(pred), t(real), t(mask)),
                     lambda: jloss.boundary_aware_loss(pred, real, mask)),
    }
    got, want = fns[name][0]().numpy(), np.asarray(fns[name][1]())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=LOSS_REL_TOL, atol=0)


def test_boundary_loss_is_exactly_zero_on_an_empty_band():
    pred, real, _ = _loss_cases()
    for mask in (np.ones_like(real), np.zeros_like(real)):
        assert boundary_band(t(mask)).sum().item() == 0.0
        assert boundary_aware_loss(t(pred), t(real), t(mask)).item() == 0.0


def test_inpainting_loss_components_match_jax(jax_vars):
    _, _, params = jax_vars
    pred, real, mask = _loss_cases()
    want_total, want = jloss.inpainting_loss(pred, real, mask, params, JLossCfg())
    got_total, got = inpainting_loss(t(pred), t(real), t(mask), vgg_from_jax_params(params, "cpu"))
    assert set(got) == set(want) == {"l1", "perceptual", "tv", "boundary", "total"}
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_REL_TOL, err_msg=k)
    _, no_vgg = inpainting_loss(t(pred), t(real), t(mask), None, InpaintingLossConfig())
    assert "perceptual" not in no_vgg


def test_bce_with_logits_matches_jax_and_torch():
    x = np.random.default_rng(7).standard_normal((3, 7, 7, 1)).astype(np.float32) * 5
    for target in (0.0, 1.0):
        got = bce_with_logits(t(x), target).item()
        want = torch.nn.functional.binary_cross_entropy_with_logits(
            t(x), torch.full((3, 7, 7, 1), target)).item()
        assert abs(got - want) < 1e-6 and abs(got - float(j_bce(jnp.asarray(x), target))) < 1e-6


def test_train_step_fp32_losses_match_jax(jax_vars):
    gv, dv, params = jax_vars
    real, mask = batch_np()
    jG, jD = JG(base_width=WIDTH), JD(base_width=WIDTH)
    jstate = JState.create(jG, jD, jax.random.PRNGKey(2), sample_shape=(2, HW, HW, 1),
                           g_variables=gv, d_variables=dv)
    jstep = j_make_train_step(jG, jD, j_adam(), j_adam(), JLossCfg(), donate=False)
    _, want = jstep(jstate, {"image": jnp.asarray(real), "mask": jnp.asarray(mask)},
                    [(jnp.asarray(k), jnp.asarray(b)) for k, b in params])
    state = GANTrainState.create(generator_from_jax_variables(gv, WIDTH, "cpu"),
                                 discriminator_from_jax_variables(dv, WIDTH, "cpu"))
    got = make_train_step()(state, {"image": t(real), "mask": t(mask)}, vgg_from_jax_params(params, "cpu"))
    assert set(got) == set(want)
    for k in ("g_loss", "d_loss", "real_loss", "fake_loss"):
        assert abs(got[k].item() - float(want[k])) < 2e-4, k
    assert state.step == 1 and state.generator.training


def _state(seed: int):
    g = torch.Generator().manual_seed(seed)
    return GANTrainState.create(init_generator(WIDTH, g, "cpu"), init_discriminator(WIDTH, g, "cpu"))


@pytest.mark.parametrize("faithful", [True, False])
def test_eval_step_d_statistics_follow_the_mode(faithful):
    real, mask = batch_np(seed=8)
    state = _state(9)
    before = {k: v.clone() for k, v in state.discriminator.state_dict().items()}
    gen, metrics = make_eval_step(torch_faithful_d_mode=faithful)(
        state, {"image": t(real), "mask": t(mask)}, init_vgg(torch.Generator().manual_seed(1), "cpu"))
    after = state.discriminator.state_dict()
    moved = any(not torch.equal(before[k], after[k]) for k in before if "running" in k)
    assert moved == faithful  # the reference quirk: D in train mode in validation
    assert gen.shape == real.shape and not gen.requires_grad
    assert set(metrics) == {"val_g_loss", "val_d_loss", "val_g_l1", "val_g_perceptual",
                            "val_g_tv", "val_g_boundary"}
    assert all(np.isfinite(v.item()) for v in metrics.values())
    assert state.generator.training and state.discriminator.training  # modes given back


def test_train_step_updates_both_networks_and_leaves_vgg_and_mask_convs():
    real, mask = batch_np(seed=10)
    state = _state(11)
    vgg = init_vgg(torch.Generator().manual_seed(2), "cpu")
    g0 = {k: v.clone() for k, v in state.generator.state_dict().items()}
    d0 = {k: v.clone() for k, v in state.discriminator.state_dict().items()}
    v0 = {k: v.clone() for k, v in vgg.state_dict().items()}
    make_train_step()(state, {"image": t(real), "mask": t(mask)}, vgg)
    g1, d1 = state.generator.state_dict(), state.discriminator.state_dict()
    assert not torch.equal(g0["enc3.input_conv.weight"], g1["enc3.input_conv.weight"])
    assert not torch.equal(d0["model.11.weight"], d1["model.11.weight"])
    assert torch.equal(g0["enc1.mask_conv.weight"], g1["enc1.mask_conv.weight"])
    assert int(d1["model.3.num_batches_tracked"]) == 3  # fake, real, fake
    assert int(g1["enc1.bn.num_batches_tracked"]) == 1
    assert all(torch.equal(v0[k], v) for k, v in vgg.state_dict().items())
    assert all(p.grad is None for p in vgg.parameters())
