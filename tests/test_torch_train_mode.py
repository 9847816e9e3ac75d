"""The port's training mode: preemption and resume in ``train()``, the load chain, and the CLI's ``--mode train``.

``train()`` under the JAX package's drill (``TERRA_GAN_TPU_FAULT=
preempt@E:B``) stops at the batch boundary, writes ``preempted.pth``
beside the master with the interrupted epoch, the best losses and the
caller's extra fields (the CLI's, at full width, the JAX ``import_pth``
reads); a run resumed
from it finishes only the remaining epochs, in the order of the
uninterrupted run (on the CPU the final weights are bitwise the
uninterrupted run's), and removes the file. ``resolve_checkpoint`` picks
as the JAX one does on each leg. The CLI runs a 3x3 Digimap-style zip
(64^2 tiles) to a full-width master checkpoint with ``--device cpu``,
exits 75 under the drill and resumes, and refuses what is not ported
with exit code 2.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from terra_gan_tpu.models import Discriminator as JD
from terra_gan_tpu.models import PConvUNet as JG
from terra_gan_tpu.training import checkpoint as jckpt
from terra_gan_tpu.training.state import GANTrainState as JState
from terra_gan_tpu_torch.cli import main_pipeline
from terra_gan_tpu_torch.config import LoopConfig
from terra_gan_tpu_torch.models.vgg import VGG16Features, vgg_state_from_hwio
from terra_gan_tpu_torch.training import loop
from terra_gan_tpu_torch.training.checkpoint import import_pth, resolve_checkpoint
from terra_gan_tpu_torch.training.state import GANTrainState
from terra_gan_tpu_torch.utils.weights import init_discriminator, init_generator, init_vgg, load_vgg
from test_torch_ingest import write_tiles, write_zip

WIDTH, HW = 8, 64


def port_state(seed: int, width: int = WIDTH) -> GANTrainState:
    g = torch.Generator().manual_seed(seed)
    return GANTrainState.create(init_generator(width, g, "cpu"), init_discriminator(width, g, "cpu"))


@pytest.fixture(scope="module")
def jax_full():
    """A full-width JAX train state to read the port's checkpoints into."""
    return JState.create(JG(), JD(), jax.random.PRNGKey(0), sample_shape=(1, HW, HW, 1))


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("splits")
    return write_tiles(root / "train", 6, seed=1, size=HW), write_tiles(root / "val", 2, seed=2,
                                                                        size=HW)


def run(state, splits, ckpt, **kw):
    train_dirs, val_dirs = splits
    return loop.train(*train_dirs, state, LoopConfig(epochs=3, batch_size=4, feed_workers=2),
                      ckpt, *val_dirs, image_size=HW, seed=1, **kw)


def test_preemption_writes_preempted_pth_with_its_extra_fields(splits, tmp_path, monkeypatch):
    monkeypatch.setenv(loop.FAULT_ENV, "preempt@1:1")
    state = port_state(0)
    ckpt = tmp_path / "master_checkpoint.pth"
    with pytest.raises(loop.TrainingPreempted) as info:
        run(state, splits, ckpt, preempt_extra={"parent": "NJ00"}, record_config={"a": 1})
    assert info.value.epoch == 1 and info.value.checkpoint == tmp_path / "preempted.pth"
    assert state.step == 3  # epoch 0's two steps and epoch 1's first
    _, extra = import_pth(tmp_path / "preempted.pth", port_state(5))
    assert extra["preempted"] is True and extra["epoch"] == 1 and extra["parent"] == "NJ00"
    assert extra["config"] == {"a": 1} and np.isfinite(extra["best_val_loss"])
    assert extra["best_train_loss"] == float("inf")  # validation decides the best
    assert not loop._PREEMPT.is_set()  # the guard clears the request on the way out


def test_resume_finishes_the_remaining_epochs_in_the_uninterrupted_order(
        splits, tmp_path, monkeypatch):
    straight = port_state(0)
    whole = run(straight, splits, tmp_path / "a" / "master_checkpoint.pth")
    assert [r["epoch"] for r in whole["history"]] == [0, 1, 2]

    monkeypatch.setenv(loop.FAULT_ENV, "preempt@1:0")
    ckpt = tmp_path / "b" / "master_checkpoint.pth"
    with pytest.raises(loop.TrainingPreempted):
        run(port_state(0), splits, ckpt)
    monkeypatch.delenv(loop.FAULT_ENV)
    resumed, extra = import_pth(ckpt.parent / "preempted.pth", port_state(9))
    rest = run(resumed, splits, ckpt, start_epoch=extra["epoch"], resume_best=extra)
    assert [r["epoch"] for r in rest["history"]] == [1, 2] and rest["final_epoch"] == 2
    assert not (ckpt.parent / "preempted.pth").exists()  # consumed by the completed run
    assert resumed.step == straight.step == 6
    for a, b in ((resumed.generator, straight.generator),
                 (resumed.discriminator, straight.discriminator)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    assert rest["best_val_loss"] == whole["best_val_loss"]


def test_sigterm_guard_requests_preemption_and_restores_the_handler():
    assert threading.current_thread() is threading.main_thread()
    before = signal.getsignal(signal.SIGTERM)
    with loop._preemption_guard():
        handler = signal.getsignal(signal.SIGTERM)
        assert handler is not before
        handler(signal.SIGTERM, None)  # what a delivered SIGTERM runs
        assert loop._PREEMPT.is_set()
    assert signal.getsignal(signal.SIGTERM) is before and not loop._PREEMPT.is_set()


@pytest.mark.parametrize("present", [("preempted", "input", "master", "baseline"),
                                     ("input", "master", "baseline"), ("master", "baseline"),
                                     ("baseline",), ()])
def test_resolve_checkpoint_legs_as_jax(present, tmp_path):
    paths = {name: tmp_path / f"{name}.pth" for name in ("preempted", "input", "master",
                                                          "baseline")}
    for name in present:
        paths[name].write_bytes(b"x")
    args = (paths["input"], paths["master"], paths["baseline"])
    got = resolve_checkpoint(*args, preempted=paths["preempted"])
    assert got == jckpt.resolve_checkpoint(*args, preempted=paths["preempted"])
    assert got == (paths[present[0]] if present else None)


def test_import_pth_takes_a_raw_generator_state_dict(tmp_path):
    src, dst = port_state(1), port_state(2)
    torch.save(src.generator.state_dict(), tmp_path / "g.pth")
    _, extra = import_pth(tmp_path / "g.pth", dst)
    assert extra == {}
    for x, y in zip(src.generator.state_dict().values(), dst.generator.state_dict().values()):
        assert torch.equal(x, y)


def test_load_vgg_reads_both_weight_formats(tmp_path):
    vgg = init_vgg(torch.Generator().manual_seed(3), "cpu")
    sd = vgg.state_dict()
    torch.save(sd, tmp_path / "vgg.pth")
    hwio = {}
    for i, idx in enumerate((0, 2, 5, 7, 10, 12, 14)):
        hwio[f"conv{i}_kernel"] = sd[f"features.{idx}.weight"].numpy().transpose(2, 3, 1, 0)
        hwio[f"conv{i}_bias"] = sd[f"features.{idx}.bias"].numpy()
    np.savez(tmp_path / "vgg.npz", **hwio)
    for path in ("vgg.pth", "vgg.npz"):
        got = load_vgg(tmp_path / path, "cpu").state_dict()
        assert all(torch.equal(got[k], v) for k, v in sd.items())
    back = vgg_state_from_hwio([(hwio[f"conv{i}_kernel"], hwio[f"conv{i}_bias"])
                                for i in range(7)])
    assert VGG16Features().load_state_dict(back, strict=True) is not None


# ------------------------------------------------------------------ CLI ----

CONFIG = """\
training:
  modes:
    initial:
      epochs: 2
      batch_size: 4
evaluation:
  checkpoint_dir: ckpts
mask_processing:
  visualization:
    enabled: false
experiment_tracking:
  enabled: false
data:
  raw_dir: data/raw
  processed_dir: data/processed
  output_dir: data/output
  input_zip_folder: data/zips
  models_dir: data/models
  image_size: 64
"""


@pytest.fixture(autouse=True)
def root_logging():
    """The CLI replaces the root logger's handlers; give the next test the ones it had."""
    handlers, level = logging.root.handlers[:], logging.root.level
    yield
    for h in logging.root.handlers[:]:
        if h not in handlers:
            logging.root.removeHandler(h)
            h.close()
    for h in handlers:
        if h not in logging.root.handlers:
            logging.root.addHandler(h)
    logging.root.setLevel(level)


def workspace(root: Path, config: str = CONFIG) -> Path:
    (root / "data" / "zips").mkdir(parents=True)
    write_zip(root / "data" / "zips")
    (root / "data" / "zips" / "src").rename(root / "src")
    (root / "config.yaml").write_text(config)
    return root


def cli(*args) -> int:
    return main_pipeline.main(["--mode", "train", "--device", "cpu", *args])


def stamped(ckpts: Path):
    return (sorted(ckpts.glob("master_checkpoint_*.pth")),
            sorted(ckpts.glob("training_metrics_*.json")))


def test_cli_train_runs_a_zip_to_a_master_checkpoint(tmp_path, monkeypatch, jax_full):
    monkeypatch.chdir(workspace(tmp_path))
    assert cli() == 0
    proc = Path("data/processed/NJ00")
    assert len(list((proc / "raw").glob("nj????.png"))) == 9
    assert len(list((proc / "raw").glob("*_mask_resized.png"))) == 9
    mapping = json.loads((proc / "metadata" / "split_mapping.json").read_text())
    assert sorted(mapping.values()) == sorted(["train", "val", "test"] * 3)
    for split in ("train", "val", "test"):
        assert len(list((proc / split / "images").iterdir())) == 3
        assert len(list((proc / split / "masks").iterdir())) == 3
    copies, metrics = stamped(Path("ckpts"))
    assert len(copies) == len(metrics) == 1
    master = Path("ckpts/master_checkpoint.pth")
    assert copies[0].read_bytes() == master.read_bytes()
    report = json.loads(metrics[0].read_text())
    assert report["successful"] == ["NJ00"] and report["failed"] == []
    assert report["metrics"]["NJ00"]["final_epoch"] == 1
    fresh = port_state(4, width=64)
    _, extra = import_pth(master, fresh)  # strict: a full-width master
    assert extra["vgg_weights_provenance"] == main_pipeline.VGG_RANDOM_TAG
    assert extra["processed_grids"] == ["NJ00"] and extra["epoch"] == 1
    assert extra["config"]["training"]["modes"]["initial"]["epochs"] == 2  # cfg.raw
    assert fresh.step == 2  # one step an epoch: 3 train tiles at batch 4
    jstate, jextra = jckpt.import_pth(master, jax_full)
    assert int(jstate.step) == 2 and jextra["processed_grids"] == ["NJ00"]


def test_cli_train_exits_75_under_the_drill_and_resumes(tmp_path, monkeypatch, jax_full):
    monkeypatch.chdir(workspace(tmp_path))
    monkeypatch.setenv(loop.FAULT_ENV, "preempt@1:0")
    assert cli() == main_pipeline.PREEMPTED_EXIT
    preempted = Path("ckpts/preempted.pth")
    _, extra = import_pth(preempted, port_state(0, width=64))
    assert extra["preempted"] and extra["epoch"] == 1 and extra["parent"] == "NJ00"
    jstate, jextra = jckpt.import_pth(preempted, jax_full)  # the JAX package reads it
    assert jextra["preempted"] is True and jextra["parent"] == "NJ00" and int(jstate.step) == 1
    assert stamped(Path("ckpts")) == ([], [])
    monkeypatch.delenv(loop.FAULT_ENV)
    assert cli() == 0
    assert not preempted.exists()
    report = json.loads(stamped(Path("ckpts"))[1][0].read_text())
    assert [r["epoch"] for r in report["metrics"]["NJ00"]["history"]] == [1]


@pytest.mark.parametrize("args,config", [
    # human_guided_train runs: its case asks it for what is still refused
    (["--mode", "human_guided_train", "--grid", "NJ00"],
     CONFIG.replace("training:\n", "training:\n  compute_dtype: bf16\n")),
    (["--mesh", "2"], CONFIG),
    ([], CONFIG.replace("training:\n", "training:\n  compute_dtype: bfloat16\n")),
    ([], CONFIG.replace("training:\n", "training:\n  qat_tail:\n    steps: 5\n")),
    ([], CONFIG.replace("evaluation:\n", "evaluation:\n  quant: w8a8\n")),
], ids=["human_guided_train", "mesh", "bf16", "qat_tail", "quant"])
def test_cli_refuses_what_is_not_ported(args, config, tmp_path, monkeypatch):
    monkeypatch.chdir(workspace(tmp_path, config))
    assert main_pipeline.main(["--mode", "train", "--device", "cpu", *args]) == 2
    assert not Path("ckpts").exists()
