"""The port's train-mode generator, one full G+D train step and three human-guided steps against the JAX package, in f64.

fp32 comparisons of train-mode gradients are ill-conditioned: train-mode
BatchNorm at the deep 1x1/2x2 stages amplifies reassociation roundoff to
1e-2..5e-2 between frameworks (tests/test_train_step.py:318-325), while
the same comparison in f64 reads ~1e-12 (tests/grad_parity_f64_main.py).
So the semantic gates run in f64, in a subprocess (``jax_enable_x64`` is
process-global): this file run as a script is that subprocess, and
prints one JSON line of measurements that the tests below hold to their
bounds. Width 8, 64^2 tiles, batch 2; weights are the JAX package's init
(fp32 values, exact in f64) carried across, VGG its ``random_weights(0)``.

One exception to f64: the JAX package's VGG rounds every layer's output
to fp32 whatever the input type (models/vgg.py:130-152; it refuses f64
inputs without a compute dtype), so with the perceptual term on, the
perceptual component, g_loss and the G update hold only to fp32 rounding
of the features. The generator gradients are gated with the perceptual
term off, as the JAX package's own f64 gate does; the D side of the full
step does not see VGG and is gated at 1e-9. The human-guided step
(``HumanGuidedTrainer.make_step`` against the JAX package's
``HumanGuidedTrainer._make_step``) runs three steps at width 8, 32^2,
batch 2, lr 1e-4, with the perceptual term off, and is gated at 1e-9:
its losses and components, and the generator's weights and BatchNorm
statistics after each step.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":
    os.environ["JAX_ENABLE_X64"] = "1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import pytest

F64_TOL = 1e-9  # the JAX package's f64 gate (tests/test_train_step.py:392-393)
VGG_F32_TOL = 1e-6  # fp32 rounding of the JAX VGG's features
LR = 2e-4
WIDTH, HW = 8, 64
HG_LR, HG_HW, HG_STEPS = 1e-4, 32, 3


def _measure() -> dict:
    import copy

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_matmul_precision", "highest")

    from terra_gan_tpu.losses import InpaintingLossConfig as JLossCfg
    from terra_gan_tpu.losses import inpainting_loss as j_inpainting_loss
    from terra_gan_tpu.models import Discriminator as JD
    from terra_gan_tpu.models import PConvUNet as JG
    from terra_gan_tpu.models.vgg import random_weights
    from terra_gan_tpu.training.state import GANTrainState as JState
    from terra_gan_tpu.training.state import adam as j_adam
    from terra_gan_tpu.training.step import bce_with_logits as j_bce
    from terra_gan_tpu.training.step import make_train_step as j_make_train_step
    from terra_gan_tpu.utils.torch_compat import (
        _hwio_to_oihw,
        discriminator_vars_to_torch_state,
        generator_vars_to_torch_state,
    )
    from terra_gan_tpu_torch.losses import InpaintingLossConfig
    from terra_gan_tpu_torch.training.state import GANTrainState
    from terra_gan_tpu_torch.training.step import (
        bce_with_logits,
        generator_objective,
        make_train_step,
    )
    from terra_gan_tpu_torch.utils.weights import (
        discriminator_from_jax_variables,
        generator_from_jax_variables,
        vgg_from_jax_params,
    )

    torch.set_default_dtype(torch.float64)
    rng = np.random.default_rng(21)
    real = rng.random((2, HW, HW, 1))
    mask = (rng.random((2, HW, HW, 1)) > 0.3).astype(np.float64)
    mask[:, 16:40, 8:32] = 0.0

    jG, jD = JG(base_width=WIDTH), JD(base_width=WIDTH)
    z = jnp.zeros((2, HW, HW, 1), jnp.float32)
    gv = jax.jit(jG.init, static_argnums=3)(jax.random.PRNGKey(0), z, z + 1, False)
    dv = jax.jit(jD.init, static_argnums=2)(jax.random.PRNGKey(1), z, False)
    f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731
    gv, dv = f64(gv), f64(dv)
    vgg_np = [(np.asarray(k), np.asarray(b)) for k, b in random_weights(0)]
    vgg64 = [(jnp.asarray(k, jnp.float64), jnp.asarray(b, jnp.float64)) for k, b in vgg_np]
    np_tree = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731

    def port_state():
        G = generator_from_jax_variables(np_tree(gv), WIDTH, "cpu").double()
        D = discriminator_from_jax_variables(np_tree(dv), WIDTH, "cpu").double()
        return GANTrainState.create(G, D, LR)

    vgg = vgg_from_jax_params(vgg_np, "cpu").double()
    batch = {"image": torch.from_numpy(real), "mask": torch.from_numpy(mask)}
    jr, jm = jnp.asarray(real), jnp.asarray(mask)
    blocks = [f"enc{i}" for i in range(1, 8)] + [f"dec{i}" for i in range(7, 0, -1)]
    out: dict = {}

    # --- the generator in train mode: output, gradients, BN statistics ---
    no_vgg = JLossCfg(perceptual_weight=0.0, tv_weight=0.1, boundary_weight=0.5)

    def j_objective(g_params):
        gen, upd = jG.apply({"params": g_params, "batch_stats": gv["batch_stats"]},
                            jr * jm, jm, True, mutable=["batch_stats"])
        loss, _ = j_inpainting_loss(gen, jr, jm, None, no_vgg)
        logits, _ = jD.apply(dv, gen, True, mutable=["batch_stats"])
        return loss + j_bce(logits, 1.0), (gen, upd["batch_stats"])

    (_, (j_gen, j_stats)), j_grads = jax.jit(
        jax.value_and_grad(j_objective, has_aux=True))(gv["params"])
    st = port_state()
    total, gen, _, _ = generator_objective(
        st, batch, None, InpaintingLossConfig(0.0, 0.1, 0.5))
    total.backward()
    G = st.generator
    out["gen_rel"] = float(np.abs(gen.detach().numpy() - np.asarray(j_gen)).max()
                           / np.abs(np.asarray(j_gen)).max())
    rels = {}
    for blk in blocks:
        jg = _hwio_to_oihw(np.asarray(j_grads[blk]["kernel"]))
        tg = G.get_submodule(blk).input_conv.weight.grad.numpy()
        rels[blk] = float(np.linalg.norm(jg - tg) / np.linalg.norm(jg))
    jg = _hwio_to_oihw(np.asarray(j_grads["final_kernel"]))
    rels["final"] = float(np.linalg.norm(jg - G.final.weight.grad.numpy()) / np.linalg.norm(jg))
    out["grad_rel"] = rels
    out["frozen_grads"] = sum(p.grad is not None for n, p in G.named_parameters()
                              if "mask_conv" in n)
    stat_rel = 0.0
    for blk in blocks:
        bn = G.get_submodule(blk).bn
        for ours, theirs in ((bn.running_mean, j_stats[blk]["bn"]["mean"]),
                             (bn.running_var, j_stats[blk]["bn"]["var"])):
            theirs = np.asarray(theirs)
            stat_rel = max(stat_rel, float(np.abs(ours.numpy() - theirs).max()
                                           / np.abs(theirs).max()))
    out["g_stats_after_forward_rel"] = stat_rel

    # --- one full G+D train step, perceptual on ---
    jstate = JState.create(jG, jD, jax.random.PRNGKey(2), sample_shape=(2, HW, HW, 1),
                           g_tx=j_adam(LR), d_tx=j_adam(LR), g_variables=gv, d_variables=dv)
    jstep = j_make_train_step(jG, jD, j_adam(LR), j_adam(LR), JLossCfg(), donate=False,
                              loss_compute_dtype=jnp.float64)
    new_j, jmetrics = jstep(jstate, {"image": jr, "mask": jm}, vgg64)
    st = port_state()
    before = copy.deepcopy(st)
    metrics = make_train_step(InpaintingLossConfig())(st, batch, vgg)
    out["metric_rel"] = {
        k: float(abs(metrics[k].item() - float(jmetrics[k])) / abs(float(jmetrics[k])))
        for k in jmetrics
    }
    out["metric_names"] = sorted(metrics)

    j_gsd = generator_vars_to_torch_state({"params": np_tree(new_j.g_params),
                                           "batch_stats": np_tree(new_j.g_stats)})
    j_dsd = discriminator_vars_to_torch_state({"params": np_tree(new_j.d_params),
                                               "batch_stats": np_tree(new_j.d_stats)})

    def sd_diffs(mod, ref):
        params, stats = 0.0, 0.0
        for k, v in ref.items():
            if k.endswith("num_batches_tracked"):
                continue
            d = float(np.abs(mod.state_dict()[k].numpy() - np.asarray(v)).max())
            if "running" in k:
                stats = max(stats, d / max(float(np.abs(np.asarray(v)).max()), 1e-300))
            else:
                params = max(params, d)
        return params, stats

    out["g_param_diff"], out["g_stats_rel"] = sd_diffs(st.generator, j_gsd)
    out["d_param_diff"], out["d_stats_rel"] = sd_diffs(st.discriminator, j_dsd)
    out["d_bn_updates"] = int(st.discriminator.model[3].num_batches_tracked)

    # the D step on the real half alone must land elsewhere
    alt = before
    g_total, gen, _, _ = generator_objective(alt, batch, vgg, InpaintingLossConfig())
    g_total.backward()
    alt.g_opt.step()
    alt.d_opt.zero_grad(set_to_none=True)
    (0.5 * bce_with_logits(alt.discriminator(batch["image"]), 1.0)).backward()
    alt.d_opt.step()
    out["d_param_diff_real_half_only"], _ = sd_diffs(alt.discriminator, j_dsd)

    # --- three human-guided steps (G alone, HumanGuidedLoss, Adam at 1e-4) ---
    from terra_gan_tpu.config import Config as JConfig
    from terra_gan_tpu.training.human_guided import HumanGuidedTrainer as JHGTrainer
    from terra_gan_tpu_torch.config import Config
    from terra_gan_tpu_torch.training.human_guided import HumanGuidedTrainer
    from terra_gan_tpu_torch.training.state import adam

    hg_raw = {"training": {"loss_weights": {"perceptual": 0.0, "tv": 0.1},
                           "modes": {"human_guided": {"learning_rate": HG_LR}}}}
    j_tx = j_adam(HG_LR)
    j_step = JHGTrainer(JConfig.from_dict(hg_raw))._make_step(jG, j_tx)
    j_params = jax.tree.map(jnp.array, gv["params"])
    j_stats = jax.tree.map(jnp.array, gv["batch_stats"])
    j_opt = j_tx.init(j_params)
    G = generator_from_jax_variables(np_tree(gv), WIDTH, "cpu").double()
    step = HumanGuidedTrainer(Config.from_dict(hg_raw)).make_step(G, adam(G.parameters(), HG_LR))
    hg_rng = np.random.default_rng(31)
    rows = []
    for _ in range(HG_STEPS):
        shape = (2, HG_HW, HG_HW, 1)
        hb = {"image": hg_rng.random(shape),
              "mask": (hg_rng.random(shape) > 0.3).astype(np.float64),
              "human_mask": (hg_rng.random(shape) > 0.85).astype(np.float64)}
        hb["mask"][:, 8:20, 4:16] = 0.0
        j_params, j_stats, j_opt, j_loss, j_comps = j_step(
            j_params, j_stats, j_opt, {k: jnp.asarray(v) for k, v in hb.items()}, None)
        loss, comps = step({k: torch.from_numpy(v) for k, v in hb.items()}, None)
        j_sd = generator_vars_to_torch_state({"params": np_tree(j_params),
                                              "batch_stats": np_tree(j_stats)})
        params, stats = sd_diffs(G, j_sd)
        rows.append({
            "loss_rel": abs(loss.item() - float(j_loss)) / abs(float(j_loss)),
            "comp_rel": {k: abs(comps[k].item() - float(v)) / max(abs(float(v)), 1e-300)
                         for k, v in j_comps.items()},
            "param_diff": params, "stats_rel": stats, "human": comps["human"].item(),
        })
    out["hg_steps"] = rows
    out["hg_comp_names"] = sorted(comps)
    return out


@pytest.fixture(scope="module")
def measured():
    try:  # inside the per-test limit (conftest.py), so a hang shows the child's stderr
        proc = subprocess.run(
            [sys.executable, __file__], capture_output=True, text=True, timeout=270,
            cwd=Path(__file__).resolve().parent.parent,
        )
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"{e}:\n{(e.stderr or b'').decode(errors='replace')[-3000:]}")
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_generator_train_mode_output_and_gradients_match_jax_f64(measured):
    assert measured["gen_rel"] <= F64_TOL
    assert max(measured["grad_rel"].values()) <= F64_TOL, measured["grad_rel"]
    assert len(measured["grad_rel"]) == 15
    assert measured["frozen_grads"] == 0  # the mask convs stay frozen


def test_generator_batch_norm_statistics_after_forward_match_jax_f64(measured):
    assert measured["g_stats_after_forward_rel"] <= F64_TOL


def test_train_step_metrics_match_jax_f64(measured):
    rel = measured["metric_rel"]
    assert set(measured["metric_names"]) == set(rel) == {
        "g_loss", "d_loss", "real_loss", "fake_loss", "g_adv_loss", "g_l1",
        "g_perceptual", "g_tv", "g_boundary",
    }
    for k, v in rel.items():
        assert v <= (VGG_F32_TOL if k in ("g_loss", "g_perceptual") else F64_TOL), (k, v)


def test_train_step_batch_norm_statistics_match_jax_f64(measured):
    assert measured["g_stats_rel"] <= F64_TOL
    assert measured["d_stats_rel"] <= F64_TOL  # after its three updates
    assert measured["d_bn_updates"] == 3


def test_train_step_parameters_match_jax_f64(measured):
    # the JAX test's bound: Adam's first step is about lr * sign(grad)
    assert measured["g_param_diff"] < 2.2 * LR
    assert measured["d_param_diff"] < 2.2 * LR


def test_human_guided_steps_match_jax_f64(measured):
    rows = measured["hg_steps"]
    assert len(rows) == HG_STEPS
    for r in rows:
        assert r["loss_rel"] <= F64_TOL, r
        assert max(r["comp_rel"].values()) <= F64_TOL, r["comp_rel"]
        assert r["human"] > 0.0  # the human term is on
    assert set(measured["hg_comp_names"]) == set(rows[0]["comp_rel"]) == {
        "l1", "tv", "boundary", "base", "human", "total"}


def test_human_guided_weights_and_statistics_match_jax_f64(measured):
    for r in measured["hg_steps"]:
        assert r["param_diff"] <= F64_TOL and r["stats_rel"] <= F64_TOL, r


def test_train_step_d_gradient_includes_the_fake_half(measured):
    assert measured["d_param_diff"] <= F64_TOL
    assert measured["d_param_diff_real_half_only"] > 1e3 * max(measured["d_param_diff"], 1e-15)


if __name__ == "__main__":
    print(json.dumps(_measure()))
