"""The port's human-guided trainer and the CLI's ``--mode human_guided_train`` on the CPU.

The trainer: its checkpoints (``generator_epoch_{e}.pth`` every epoch,
``best_model.pth`` when ``0 < average < best``, the JAX package's keys
and torch's state-dict keys), NaN batch losses left out of the average,
the ``preempt@0:1`` drill and ``preempted.pth`` consumed by a completed
run. The CLI end to end at full width (base_width 64) on 64^2 tiles,
batch 5 over 7 tiles (batches of 5 and 2), with the port's portal server
in a thread and without a portal: exit 0, 1 and 75, the master's keys,
the JAX package's ``load_generator_variables`` reading the port's master
and the port starting from a master the JAX package wrote, and
``--mode train``'s load of an HG master as the JAX ``import_pth`` loads
it. The step itself is held to the JAX package's in f64 by
tests/test_torch_train_f64.py.
"""

from __future__ import annotations

import base64
import json
import math
import threading
from pathlib import Path
from wsgiref.simple_server import WSGIRequestHandler, make_server

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from terra_gan_tpu.evaluation.inference import load_generator_variables
from terra_gan_tpu.models import Discriminator as JD
from terra_gan_tpu.models import PConvUNet as JG
from terra_gan_tpu.training import checkpoint as jckpt
from terra_gan_tpu.training.state import GANTrainState as JState
from terra_gan_tpu.utils.torch_compat import save_pth as jax_save_pth
from terra_gan_tpu.utils.torch_compat import (
    torch_state_to_discriminator_vars,
    torch_state_to_generator_vars,
)
from terra_gan_tpu_torch.cli import main_pipeline
from terra_gan_tpu_torch.config import Config
from terra_gan_tpu_torch.data.dataset import DirectMatchDataset
from terra_gan_tpu_torch.models.generator import PConvUNet
from terra_gan_tpu_torch.portal import client as client_mod
from terra_gan_tpu_torch.portal import jwt_auth
from terra_gan_tpu_torch.portal.client import PortalClient
from terra_gan_tpu_torch.portal.server import create_app
from terra_gan_tpu_torch.training import human_guided, loop
from terra_gan_tpu_torch.training.checkpoint import import_pth
from terra_gan_tpu_torch.training.state import GANTrainState
from terra_gan_tpu_torch.utils.torch_compat import generator_vars_to_torch_state
from terra_gan_tpu_torch.utils.weights import init_discriminator, init_generator, load_generator

HW, GRID, N_TILES, BATCH = 64, "NJ05", 7, 5
TILES = [f"nj09{50 + i}" for i in range(N_TILES)]
SECRET = "hg-test-secret"
HG_KEYS = {"generator_state_dict", "architecture", "human_guided", "source_model",
           "resumed_from_preemption", "grid_square", "best_loss", "config",
           "vgg_weights_provenance"}
CONFIG = """\
training:
  loss_weights:
    perceptual: {perceptual}
  modes:
    human_guided:
      epochs: {epochs}
      batch_size: {batch}
evaluation:
  checkpoint_dir: ckpts
experiment_tracking:
  enabled: false
data:
  processed_dir: data/processed
  output_dir: data/output
  input_zip_folder: data/zips
  image_size: {hw}
"""


def write_png(path: Path, arr) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)
    return path


def write_split(root: Path, seed: int = 0, empty_human: bool = False) -> dict:
    """A grid's test split and one human annotation a tile, as the portal
    names it; returns {tile: annotation PNG bytes}."""
    rng = np.random.default_rng(seed)
    split = root / "data" / "processed" / GRID / "test"
    annotations = {}
    for t in TILES:
        write_png(split / "images" / f"{t}.png", rng.integers(0, 256, (HW, HW), dtype=np.uint8))
        write_png(split / "masks" / f"{t}_mask_resized.png",
                  ((rng.random((HW, HW)) > 0.3) * 255).astype(np.uint8))
        human = np.zeros((HW, HW), np.uint8) if empty_human else \
            ((rng.random((HW, HW)) > 0.8) * 255).astype(np.uint8)
        png = root / "tmp.png"
        write_png(png, human)
        annotations[t] = png.read_bytes()
    return annotations


def workspace(root: Path, epochs: int = 1, perceptual: float = 0.0, width: int = 64,
              empty_human: bool = False, local: bool = True, portal: str = "") -> dict:
    """Config, seeded master, test split and (with ``local``) the annotations
    in the grid's human_annotation_masks directory."""
    cfg = CONFIG.format(perceptual=perceptual, epochs=epochs, batch=BATCH, hw=HW) + portal
    (root / "config.yaml").write_text(cfg)
    G = init_generator(width, torch.Generator().manual_seed(3), "cpu")
    (root / "ckpts").mkdir()
    torch.save({"epoch": 0, "generator_state_dict": G.state_dict()},
               root / "ckpts" / "master_checkpoint.pth")
    annotations = write_split(root, empty_human=empty_human)
    if local:
        hdir = root / "data" / "output" / GRID / "human_annotation_masks"
        hdir.mkdir(parents=True)
        for t, png in annotations.items():
            (hdir / f"{GRID}_colored_{t}_u1a2_mask.png").write_bytes(png)
    return annotations


def cli(*args) -> int:
    return main_pipeline.main(["--mode", "human_guided_train", "--config", "config.yaml",
                               "--device", "cpu", *args])


def hg_masters(ckpts: Path):
    return sorted(ckpts.glob("master_model_human_guided_*.pth"))


# --- the trainer ---------------------------------------------------------------

@pytest.fixture()
def small(tmp_path, monkeypatch):
    """A width-8 generator, a DirectMatchDataset of the 7 tiles, a config."""
    monkeypatch.chdir(tmp_path)
    workspace(tmp_path, width=8)
    raw = {"training": {"loss_weights": {"perceptual": 0.0},
                        "modes": {"human_guided": {"epochs": 2, "batch_size": BATCH}}}}
    from terra_gan_tpu_torch.portal.helpers import match_human_and_system_masks

    cfg = Config.from_dict({**raw, "data": {"processed_dir": "data/processed",
                                            "output_dir": "data/output"}})
    pairs = match_human_and_system_masks(GRID, cfg)
    assert [p["tile_name"] for p in pairs] == TILES
    G = load_generator(tmp_path / "ckpts" / "master_checkpoint.pth", "cpu")
    return G, DirectMatchDataset(pairs, size=HW), cfg


def scripted_steps(monkeypatch, losses):
    """The trainer's step replaced by one that returns ``losses`` in turn."""
    it = iter(losses)

    def make_step(self, generator, opt):
        return lambda batch, vgg: (torch.tensor(next(it), dtype=torch.float64), {})

    monkeypatch.setattr(human_guided.HumanGuidedTrainer, "make_step", make_step)


def test_trainer_checkpoints_as_jax_names_them(small, tmp_path):
    G, ds, cfg = small
    before = {k: v.clone() for k, v in G.state_dict().items()}
    result = human_guided.HumanGuidedTrainer(cfg).train(G, ds, checkpoint_dir=tmp_path / "hg")
    names = sorted(p.name for p in (tmp_path / "hg").iterdir())
    assert names == ["best_model.pth", "generator_epoch_0.pth", "generator_epoch_1.pth"]
    assert len(result["epoch_losses"]) == 2 and all(v > 0 for v in result["epoch_losses"])
    assert result["best_loss"] == min(result["epoch_losses"]) and result["generator"] is G
    last = torch.load(tmp_path / "hg" / "generator_epoch_1.pth", weights_only=True)
    assert list(last) == ["epoch", "model_state_dict", "loss", "config"]
    assert last["epoch"] == 1 and last["loss"] == result["epoch_losses"][1]
    assert last["config"] == cfg.raw
    fresh = PConvUNet(8)
    fresh.load_state_dict(last["model_state_dict"], strict=True)
    assert all(torch.equal(v, G.state_dict()[k]) for k, v in fresh.state_dict().items())
    assert any(not torch.equal(v, before[k]) for k, v in G.state_dict().items())
    # BatchNorm's statistics moved once a step: 2 epochs of 2 batches
    assert int(G.enc1.bn.num_batches_tracked) == 4
    jvars = load_generator_variables(tmp_path / "hg" / "best_model.pth")  # the JAX reader
    assert set(jvars) == {"params", "batch_stats"}


@pytest.mark.parametrize("losses,avgs,best_epoch", [
    ([0.5, 0.5, 0.7, 0.7, 0.3, 0.3], [0.5, 0.7, 0.3], 2),
    ([0.4, 0.2, 0.0, 0.0, 0.5, 0.3], [(0.4 + 0.2) / 2, 0.0, 0.4], 0),
    ([1.0, float("nan"), float("inf"), 2.0, float("nan"), float("nan")],
     [1.0, 2.0, 0.0], 0),
], ids=["improves", "zero_never_best", "nan_left_out"])
def test_best_model_rule_and_non_finite_losses(small, tmp_path, monkeypatch, losses, avgs,
                                               best_epoch):
    G, ds, cfg = small
    scripted_steps(monkeypatch, losses)
    result = human_guided.HumanGuidedTrainer(cfg).train(G, ds, num_epochs=3,
                                                        checkpoint_dir=tmp_path / "hg")
    assert result["epoch_losses"] == avgs
    best = torch.load(tmp_path / "hg" / "best_model.pth", weights_only=True)
    assert best["epoch"] == best_epoch and best["loss"] == avgs[best_epoch]
    assert result["best_loss"] == min(a for a in avgs if a > 0)


def test_no_positive_epoch_writes_no_best_model(small, tmp_path, monkeypatch):
    G, ds, cfg = small
    scripted_steps(monkeypatch, [float("nan"), 0.0])
    result = human_guided.HumanGuidedTrainer(cfg).train(G, ds, num_epochs=1,
                                                        checkpoint_dir=tmp_path / "hg")
    assert result["best_loss"] is None and result["epoch_losses"] == [0.0]
    assert not (tmp_path / "hg" / "best_model.pth").exists()


def test_preempt_drill_then_a_completed_run_consumes_it(small, tmp_path, monkeypatch):
    G, ds, cfg = small
    seed = {k: v.clone() for k, v in G.state_dict().items()}
    monkeypatch.setenv(loop.FAULT_ENV, "preempt@0:1")
    with pytest.raises(loop.TrainingPreempted) as info:
        human_guided.HumanGuidedTrainer(cfg).train(G, ds, checkpoint_dir=tmp_path / "hg")
    pre = tmp_path / "hg" / "preempted.pth"
    assert info.value.epoch == 0 and info.value.checkpoint == pre
    obj = torch.load(pre, weights_only=True)
    assert list(obj) == ["epoch", "model_state_dict", "preempted", "config"]
    assert obj["epoch"] == 0 and obj["preempted"] is True
    assert int(obj["model_state_dict"]["enc1.bn.num_batches_tracked"]) == 1  # one step
    assert any(not torch.equal(v, seed[k]) for k, v in obj["model_state_dict"].items())
    assert not loop._PREEMPT.is_set()
    monkeypatch.delenv(loop.FAULT_ENV)
    human_guided.HumanGuidedTrainer(cfg).train(load_generator(pre, "cpu"), ds,
                                               checkpoint_dir=tmp_path / "hg")
    assert not pre.exists()


def test_to_device_leaves_the_tile_names_behind(small):
    _, ds, _ = small
    from terra_gan_tpu_torch.data.dataset import BatchLoader

    batch = next(iter(BatchLoader(ds, BATCH)))
    assert len(batch["tile_name"]) == BATCH
    moved = loop._to_device(batch, torch.device("cpu"))
    assert set(moved) == {"image", "mask", "human_mask"}
    assert moved["human_mask"].shape == (BATCH, HW, HW, 1)


# --- the CLI -------------------------------------------------------------------

class _Quiet(WSGIRequestHandler):
    def log_message(self, *args):
        pass


@pytest.fixture()
def portal_server(tmp_path):
    app = create_app(tmp_path / "portal" / "images", tmp_path / "portal" / "annotations",
                     secret_key=SECRET)
    server = make_server("127.0.0.1", 0, app, handler_class=_Quiet)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_port}", tmp_path / "portal"
    server.shutdown()
    server.server_close()
    thread.join(timeout=5)


def annotate_through_the_portal(url: str, annotations: dict, root: Path) -> str:
    """Upload the grid's tiles with the client, then save one annotation a
    tile as the annotator's page posts it; returns the bearer token."""
    import urllib.request

    token = jwt_auth.encode({"sub": "pipeline"}, SECRET, expires_in=600)
    images = sorted((root / "data" / "processed" / GRID / "test" / "images").glob("*.png"))
    colored = []
    for p in images:  # the names evaluate's colorizer writes
        colored.append(root / "colored" / f"{p.stem}_inpainted_colored.png")
        write_png(colored[-1], np.asarray(Image.open(p)))
    assert PortalClient(url, token).upload_batch(GRID, colored)
    for p in colored:
        body = json.dumps({"image_name": f"{GRID}_{p.name}", "user_hash": "u1a2",
                           "mask": "data:image/png;base64,"
                           + base64.b64encode(annotations[p.stem[:6]]).decode()}).encode()
        req = urllib.request.Request(f"{url}/save_annotation", data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
    return token


def test_cli_with_the_portal_end_to_end(tmp_path, monkeypatch, portal_server):
    url, portal_root = portal_server
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(client_mod, "CHUNK_DELAY_S", 0.0)
    monkeypatch.setenv("EXPERIMENT_MODE", "true")
    annotations = workspace(tmp_path, perceptual=0.1, local=False)
    token = annotate_through_the_portal(url, annotations, tmp_path)
    assert len(list((portal_root / "annotations").iterdir())) == N_TILES
    (tmp_path / "config.yaml").write_text((tmp_path / "config.yaml").read_text()
                                          + f"portal:\n  base_url: {url}\n  api_key: {token}\n")
    seed = torch.load("ckpts/master_checkpoint.pth", weights_only=True)["generator_state_dict"]
    assert cli("--grid", GRID) == 0
    hdir = Path("data/output") / GRID / "human_annotation_masks"
    assert sorted(p.name for p in hdir.iterdir()) == [
        f"{GRID}_{t}_inpainted_colored_u1a2_mask.png" for t in TILES]
    assert list((portal_root / "annotations").iterdir()) == []  # cleaned up
    (stamped,) = hg_masters(Path("ckpts"))
    master = torch.load("ckpts/master_checkpoint.pth", weights_only=True)
    copy = torch.load(stamped, weights_only=True)
    assert set(master) == set(copy) == HG_KEYS
    assert all(torch.equal(v, copy["generator_state_dict"][k])
               for k, v in master["generator_state_dict"].items())
    assert master["human_guided"] is True and master["grid_square"] == GRID
    assert master["architecture"] == "pconv_unet"
    assert master["source_model"] == str(Path("ckpts/master_checkpoint.pth"))
    assert master["resumed_from_preemption"] is False
    assert master["vgg_weights_provenance"] == main_pipeline.VGG_RANDOM_TAG
    assert math.isfinite(master["best_loss"]) and master["best_loss"] > 0
    assert any(not torch.equal(v, seed[k]) for k, v in master["generator_state_dict"].items())
    # the JAX package reads the port's master
    jvars = load_generator_variables("ckpts/master_checkpoint.pth")
    want = generator_vars_to_torch_state(jax.tree.map(np.asarray, jvars))
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):  # the JAX package keeps no count
            assert np.array_equal(np.asarray(v), master["generator_state_dict"][k].numpy()), k
    sub = sorted(p.name for p in Path("ckpts/human_guided").iterdir())
    assert sub == ["best_model.pth", "generator_epoch_0.pth"]


def test_cli_from_a_jax_written_master_without_a_portal(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    workspace(tmp_path)
    sd = torch.load("ckpts/master_checkpoint.pth", weights_only=True)["generator_state_dict"]
    jvars = torch_state_to_generator_vars({k: v.numpy() for k, v in sd.items()})
    jax_save_pth("jax_master.pth", {"generator_state_dict": generator_vars_to_torch_state(
        jax.tree.map(np.asarray, jvars))})
    assert cli("--grid", GRID, "--input_model", "jax_master.pth") == 0
    master = torch.load("ckpts/master_checkpoint.pth", weights_only=True)
    assert master["source_model"] == "jax_master.pth"
    assert master["vgg_weights_provenance"] == "none"
    assert len(hg_masters(Path("ckpts"))) == 1


@pytest.mark.parametrize("case", ["no_pairs", "all_empty", "no_model", "no_grid"])
def test_cli_exits_1(tmp_path, monkeypatch, case):
    monkeypatch.chdir(tmp_path)
    workspace(tmp_path, width=8, empty_human=case == "all_empty")
    args = ["--grid", GRID]
    if case == "no_pairs":  # names without a tile token: nothing matches
        for p in (tmp_path / "data" / "output" / GRID / "human_annotation_masks").iterdir():
            p.rename(p.with_name(p.name.replace("nj09", "x")))
    elif case == "no_model":
        Path("ckpts/master_checkpoint.pth").unlink()
    elif case == "no_grid":
        args = []
        monkeypatch.setattr("builtins.input", lambda prompt: "  ")
    seed = Path("ckpts/master_checkpoint.pth").read_bytes() if case != "no_model" else None
    assert cli(*args) == 1
    assert hg_masters(Path("ckpts")) == []
    if seed is not None:
        assert Path("ckpts/master_checkpoint.pth").read_bytes() == seed


def test_cli_grid_from_the_first_zip_or_the_prompt(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    workspace(tmp_path, width=8)
    Path("data/zips").mkdir(parents=True)
    for name in ("nj05.zip", "su12.zip"):
        Path("data/zips", name).write_bytes(b"")
    monkeypatch.setenv("EXPERIMENT_MODE", "1")
    assert cli() == 0
    assert torch.load("ckpts/master_checkpoint.pth", weights_only=True)["grid_square"] == GRID
    monkeypatch.delenv("EXPERIMENT_MODE")
    monkeypatch.setattr("builtins.input", lambda prompt: " nj05 ")
    assert cli() == 0 and len(hg_masters(Path("ckpts"))) >= 1


def test_cli_exits_75_under_the_drill_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    workspace(tmp_path, epochs=2)
    seed = Path("ckpts/master_checkpoint.pth").read_bytes()
    monkeypatch.setenv(loop.FAULT_ENV, "preempt@0:1")
    assert cli("--grid", GRID) == main_pipeline.PREEMPTED_EXIT
    pre = Path("ckpts/human_guided/preempted.pth")
    assert pre.exists() and hg_masters(Path("ckpts")) == []
    assert Path("ckpts/master_checkpoint.pth").read_bytes() == seed
    assert load_generator_variables(pre)  # the JAX package reads it
    monkeypatch.delenv(loop.FAULT_ENV)
    assert cli("--grid", GRID) == 0
    master = torch.load("ckpts/master_checkpoint.pth", weights_only=True)
    assert master["resumed_from_preemption"] is True and not pre.exists()
    assert master["source_model"] == str(Path("ckpts/master_checkpoint.pth"))
    # the kept fault: the resumed run starts again at epoch 0 and runs both
    # epochs, so its generator took 1 + 2 * 2 steps
    assert int(master["generator_state_dict"]["enc1.bn.num_batches_tracked"]) == 5
    assert sorted(p.name for p in Path("ckpts/human_guided").glob("generator_epoch_*")) == [
        "generator_epoch_0.pth", "generator_epoch_1.pth"]


def test_train_mode_loads_an_hg_master_as_jax_does(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    workspace(tmp_path, width=8)
    assert cli("--grid", GRID) == 0
    g = torch.Generator().manual_seed(11)
    state = GANTrainState.create(init_generator(8, g, "cpu"), init_discriminator(8, g, "cpu"))
    d_before = {k: v.clone() for k, v in state.discriminator.state_dict().items()}
    g_before = {k: v.clone() for k, v in state.generator.state_dict().items()}
    state, extra = import_pth("ckpts/master_checkpoint.pth", state)
    master = torch.load("ckpts/master_checkpoint.pth", weights_only=True)
    assert all(torch.equal(v, master["generator_state_dict"][k])
               for k, v in state.generator.state_dict().items())
    assert all(torch.equal(v, d_before[k]) for k, v in state.discriminator.state_dict().items())
    assert state.step == 0 and state.g_opt.state_dict()["state"] == {}
    assert extra["human_guided"] is True and extra["grid_square"] == GRID
    # the JAX template holds the same seeded D (and G), carried across
    np_sd = lambda sd: {k: v.numpy() for k, v in sd.items()}  # noqa: E731
    template = JState.create(JG(base_width=8), JD(base_width=8), jax.random.PRNGKey(0),
                             g_variables=torch_state_to_generator_vars(np_sd(g_before)),
                             d_variables=torch_state_to_discriminator_vars(np_sd(d_before)))
    jstate, jextra = jckpt.import_pth("ckpts/master_checkpoint.pth", template)
    assert int(jstate.step) == 0 and jextra["human_guided"] is True
    assert jax.tree.all(jax.tree.map(np.array_equal, jstate.d_params, template.d_params))
    jsd = generator_vars_to_torch_state({"params": jax.tree.map(np.asarray, jstate.g_params),
                                         "batch_stats": jax.tree.map(np.asarray,
                                                                     jstate.g_stats)})
    for k, v in jsd.items():
        if not k.endswith("num_batches_tracked"):  # the JAX package keeps no count
            assert np.array_equal(np.asarray(v), master["generator_state_dict"][k].numpy()), k
