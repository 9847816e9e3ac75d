"""The port's training state across packages: parameter order, .pth both ways, the loop and its data.

The reference numbers torch Adam state by ``.parameters()`` order, the
generator's 14 frozen mask convs included (72 entries; 16 for D), and
the JAX package's ``export_pth`` / ``import_pth`` keep that numbering
(terra_gan_tpu/training/checkpoint.py:83-115, 160-227). These tests
write a master checkpoint in one package and read it in the other, with
the Adam moments compared entry by entry, and run the port's ``train``
over a directory of 64^2 PNGs at width 8, whose best checkpoint the
JAX package then reads.
"""

from __future__ import annotations

import logging
from dataclasses import asdict

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from terra_gan_tpu.data.dataset import BatchLoader as JBatchLoader
from terra_gan_tpu.data.dataset import InpaintingDataset as JInpaintingDataset
from terra_gan_tpu.evaluation.inference import load_generator_variables
from terra_gan_tpu.models import Discriminator as JD
from terra_gan_tpu.models import PConvUNet as JG
from terra_gan_tpu.training import checkpoint as jckpt
from terra_gan_tpu.training.state import GANTrainState as JState
from terra_gan_tpu_torch.config import LoopConfig, TrainingConfig
from terra_gan_tpu_torch.data.dataset import BatchLoader, InpaintingDataset
from terra_gan_tpu_torch.models import PConvUNet
from terra_gan_tpu_torch.training import loop
from terra_gan_tpu_torch.training.checkpoint import export_pth, import_pth
from terra_gan_tpu_torch.training.state import GANTrainState
from terra_gan_tpu_torch.training.step import make_train_step
from terra_gan_tpu_torch.utils.weights import init_discriminator, init_generator

WIDTH, HW = 8, 64


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def port_state(seed: int) -> GANTrainState:
    g = torch.Generator().manual_seed(seed)
    return GANTrainState.create(init_generator(WIDTH, g, "cpu"), init_discriminator(WIDTH, g, "cpu"))


@pytest.fixture(scope="module")
def jax_template():
    return JState.create(JG(base_width=WIDTH), JD(base_width=WIDTH), jax.random.PRNGKey(0),
                         sample_shape=(1, HW, HW, 1))


def write_tiles(root, n: int, seed: int, size: int = HW):
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size), dtype=np.uint8)).save(
            root / "images" / f"t{i:02d}.png")
        mask = (rng.random((size, size)) > 0.3) * 255
        mask[size // 4 : size // 2, size // 4 : size // 2] = 0
        Image.fromarray(mask.astype(np.uint8)).save(root / "masks" / f"t{i:02d}.png")
    return root / "images", root / "masks"


def test_generator_parameter_order_is_the_references():
    names = [n for n, _ in PConvUNet(WIDTH).named_parameters()]
    assert names == [n for n, _ in jckpt._gen_param_entries()] and len(names) == 72
    frozen = [n for n, p in PConvUNet(WIDTH).named_parameters() if not p.requires_grad]
    assert frozen == [n for n, spec in jckpt._gen_param_entries() if spec is None]


def _random_adam(opt_state, seed: int, count: int):
    """The optax Adam state with random moments and a step count."""
    rng = np.random.default_rng(seed)
    adam = opt_state[0]
    draw = lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)  # noqa: E731
    adam = adam._replace(count=jnp.asarray(count, jnp.int32), mu=jax.tree.map(draw, adam.mu),
                         nu=jax.tree.map(lambda a: jnp.abs(draw(a)), adam.nu))
    return (adam, *opt_state[1:])


def _moments_equal(opt: torch.optim.Adam, adam, entries, count: int):
    state = opt.state_dict()["state"]
    trained = [i for i, (_, spec) in enumerate(entries) if spec is not None]
    assert sorted(state) == trained
    for i in trained:
        spec = entries[i][1]
        for ours, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            want = jckpt._oihw(np.asarray(jckpt._get_leaf(theirs, spec)))
            np.testing.assert_array_equal(state[i][ours].numpy(), want, err_msg=entries[i][0])
        assert int(state[i]["step"]) == count


def test_jax_optimizer_states_load_into_the_port(jax_template, tmp_path):
    jstate = jax_template.replace(g_opt=_random_adam(jax_template.g_opt, 1, 3),
                                  d_opt=_random_adam(jax_template.d_opt, 2, 3))
    path = tmp_path / "jax.pth"
    jckpt.export_pth(path, jstate, epoch=4, extra={"g_loss": 1.5})
    state = port_state(0)
    _, extra = import_pth(path, state)  # strict state dicts, both Adams
    assert extra["epoch"] == 4 and extra["g_loss"] == 1.5 and state.step == 3
    _moments_equal(state.g_opt, jstate.g_opt[0], jckpt._gen_param_entries(), 3)
    _moments_equal(state.d_opt, jstate.d_opt[0], jckpt._disc_param_entries(), 3)
    got = state.generator.state_dict()["enc2.input_conv.weight"].numpy()
    np.testing.assert_array_equal(got, jckpt._oihw(np.asarray(jstate.g_params["enc2"]["kernel"])))


def test_port_optimizer_states_load_into_jax(jax_template, tmp_path):
    state = port_state(1)
    rng = np.random.default_rng(3)
    real = rng.random((2, HW, HW, 1), dtype=np.float32)
    mask = (rng.random((2, HW, HW, 1)) > 0.3).astype(np.float32)
    for _ in range(2):
        make_train_step()(state, {"image": t(real), "mask": t(mask)}, None)
    path = tmp_path / "port.pth"
    export_pth(path, state, epoch=1, config={"epochs": 2})
    jstate, extra = jckpt.import_pth(path, jax_template)
    assert extra["epoch"] == 1 and extra["config"] == {"epochs": 2}
    assert int(jstate.step) == 2 == state.step
    _moments_equal(state.g_opt, jstate.g_opt[0], jckpt._gen_param_entries(), 2)
    _moments_equal(state.d_opt, jstate.d_opt[0], jckpt._disc_param_entries(), 2)
    np.testing.assert_array_equal(
        np.asarray(jstate.d_stats["block2_bn"]["var"]),
        state.discriminator.state_dict()["model.6.running_var"].numpy(),
    )


def test_batch_loader_streams_the_jax_batches(tmp_path):
    images, masks = write_tiles(tmp_path, 10, seed=4, size=72)  # resized to 64
    ours = BatchLoader(InpaintingDataset(images, masks, size=HW), batch_size=4, seed=3)
    theirs = JBatchLoader(JInpaintingDataset(images, masks, size=HW, cache_bytes=0),
                          batch_size=4, seed=3, num_workers=1)
    for _ in range(2):  # one permutation per epoch from the same stream
        got, want = list(ours), list(theirs)
        assert [b["image"].shape[0] for b in got] == [4, 4, 2] == [b["image"].shape[0] for b in want]
        for a, b in zip(got, want):
            assert a.keys() == b.keys() == {"image", "mask"}
            for k in a:
                assert a[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k])
    assert set(np.unique(got[0]["mask"])) <= {0.0, 1.0}


def test_batch_loader_skips_a_bad_batch_and_raises_when_all_fail(tmp_path, caplog, monkeypatch):
    images, masks = write_tiles(tmp_path, 4, seed=5)
    (images / "t00.png").write_bytes(b"not a png")
    # no tile cache: every pass decodes the files as they are now
    monkeypatch.setenv("TERRA_GAN_TPU_TILE_CACHE_MB", "0")
    loader = BatchLoader(InpaintingDataset(images, masks, size=HW), batch_size=2, shuffle=False)
    with caplog.at_level(logging.ERROR):
        batches = list(loader)
    assert len(batches) == 1 and "batch load failed" in caplog.text
    for p in images.iterdir():
        p.write_bytes(b"not a png")
    with pytest.raises(RuntimeError, match="every batch failed"):
        list(loader)


def test_train_writes_a_best_checkpoint_that_jax_reads(jax_template, tmp_path):
    train_dirs = write_tiles(tmp_path / "train", 6, seed=6)
    val_dirs = write_tiles(tmp_path / "val", 2, seed=7)
    state = port_state(2)
    best = tmp_path / "ckpt" / "best.pth"
    result = loop.train(*train_dirs, state, LoopConfig(epochs=2, batch_size=4), best,
                        *val_dirs, image_size=HW, seed=1)
    assert [r["steps"] for r in result["history"]] == [2, 2] and state.step == 4
    assert result["final_epoch"] == 1 and np.isfinite(result["best_val_loss"])
    assert result["best_val_loss"] == min(r["val_g_loss"] for r in result["history"])
    assert state.generator.training  # validation gave G back in train mode
    assert sorted(p.name for p in best.parent.iterdir()) == ["best.pth", "checkpoint_epoch_0.pth"]

    variables = load_generator_variables(best)
    x = np.random.default_rng(8).random((1, HW, HW, 1), dtype=np.float32)
    m = np.ones_like(x)
    m[:, 20:40, 10:50] = 0
    want = np.asarray(JG(base_width=WIDTH).apply(variables, jnp.asarray(x * m), jnp.asarray(m), False))
    saved = port_state(3)
    _, extra = import_pth(best, saved)
    with torch.no_grad():
        got = saved.generator.eval()(t(x * m), t(m)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    jstate, jextra = jckpt.import_pth(best, jax_template)
    assert jextra["epoch"] == extra["epoch"] and int(jstate.step) == saved.step
    _moments_equal(saved.g_opt, jstate.g_opt[0], jckpt._gen_param_entries(), saved.step)


def test_train_runs_at_the_configs_learning_rate(tmp_path):
    dirs = write_tiles(tmp_path, 2, seed=10)
    state = port_state(6)  # Adams built at the default 2e-4
    before = {n: p.detach().clone() for n, p in state.generator.named_parameters()}
    best = tmp_path / "ckpt" / "best.pth"
    loop.train(*dirs, state, LoopConfig(epochs=1, batch_size=2, learning_rate=1e-3), best,
               image_size=HW)
    assert state.step == 1
    # Adam's first step moves a weight by about lr * sign(grad)
    moved = max((p.detach() - before[n]).abs().max().item()
                for n, p in state.generator.named_parameters() if p.requires_grad)
    assert 0.9e-3 < moved <= 1.0001e-3
    saved = torch.load(best, weights_only=False)
    assert saved["config"]["learning_rate"] == 1e-3
    for key in ("optimizer_G_state_dict", "optimizer_D_state_dict"):
        assert [g["lr"] for g in saved[key]["param_groups"]] == [1e-3]


def test_train_skips_a_failed_step_and_raises_when_every_step_fails(tmp_path, monkeypatch):
    dirs = write_tiles(tmp_path, 4, seed=9)
    real_make = loop.make_train_step
    calls = []

    def failing_first(cfg):
        step = real_make(cfg)

        def run(state, batch, vgg):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("injected")
            return step(state, batch, vgg)

        return run

    monkeypatch.setattr(loop, "make_train_step", failing_first)
    state = port_state(4)
    result = loop.train(*dirs, state, LoopConfig(epochs=1, batch_size=2), image_size=HW)
    assert result["history"][0]["steps"] == 1 and state.step == 1
    assert result["best_val_loss"] is None

    def always(cfg):
        def run(state, batch, vgg):
            raise RuntimeError("injected")
        return run

    monkeypatch.setattr(loop, "make_train_step", always)
    with pytest.raises(RuntimeError, match="no progress"):
        loop.train(*dirs, port_state(5), LoopConfig(epochs=1, batch_size=2), image_size=HW)


def test_training_config_has_the_jax_defaults():
    from terra_gan_tpu.config import TrainingConfig as JTrainingConfig

    theirs = JTrainingConfig()
    assert asdict(TrainingConfig()) == asdict(theirs)
    # the loop's flat view, by default and as derived from the nested section
    for ours in (LoopConfig(), LoopConfig.from_training(TrainingConfig())):
        init = theirs.initial
        assert (ours.epochs, ours.batch_size, ours.learning_rate, ours.log_interval,
                ours.checkpoint_interval) == (init.epochs, init.batch_size, init.learning_rate,
                                              init.log_interval, init.checkpoint_interval)
        assert (ours.perceptual, ours.tv) == (theirs.loss_weights.perceptual,
                                              theirs.loss_weights.tv)
        assert ours.boundary == theirs.effective_boundary_weight() == 0.5
