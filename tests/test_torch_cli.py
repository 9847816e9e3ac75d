"""The port's pipeline CLI (evaluate) against the JAX package's.

A processed tree is written straight to disk (two parent grids, each
with a test split of 64^2 PNG tiles and masks; no zip, no OpenCV) with a
full-width master checkpoint written by the JAX package. The JAX CLI's
``run_evaluation_mode`` and the port's CLI (``--device cpu``) evaluate
it into two output trees: the inpainted PNGs must agree within 1 grey
level, and the colored PNGs must be equal where the inpainted ones are
(the JAX colorizer, through OpenCV, run on the port's inpainted PNGs
gives the port's colored PNGs).
"""

from __future__ import annotations

import logging
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from terra_gan_tpu.cli.main_pipeline import _load_config as jax_load_config
from terra_gan_tpu.cli.main_pipeline import run_evaluation_mode as jax_run_evaluation_mode
from terra_gan_tpu.models import PConvUNet as JG
from terra_gan_tpu.utils.torch_compat import generator_vars_to_torch_state, save_pth
from terra_gan_tpu_torch.cli import main_pipeline
from terra_gan_tpu_torch.data.visualization import build_lut

REPO = Path(__file__).resolve().parents[1]
HW, TILES, GRIDS = 64, 3, ("NJ00", "SU12")
CONFIG = """\
evaluation:
  checkpoint_dir: ckpts
experiment_tracking:
  enabled: false
data:
  processed_dir: data/processed
  output_dir: {out}
  image_size: {hw}
"""


@pytest.fixture(autouse=True)
def root_logging():
    """The CLI replaces the root logger's handlers (console and logs/pipeline.log,
    as the JAX CLI does); give the next test the ones it had."""
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


def write_tree(root: Path) -> None:
    """Two parent grids' test splits, a JAX-written master checkpoint, two configs."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:HW, 0:HW] / HW
    for g, grid in enumerate(GRIDS):
        split = root / "data" / "processed" / grid / "test"
        (split / "images").mkdir(parents=True)
        (split / "masks").mkdir(parents=True)
        for i in range(TILES):
            z = np.sin(2 * np.pi * (rng.uniform(0.5, 2) * yy + rng.uniform(0.5, 2) * xx))
            z = z + 0.3 * rng.random((HW, HW))
            img = ((z - z.min()) / (z.max() - z.min()) * 255).astype(np.uint8)
            mask = np.full((HW, HW), 255, np.uint8)
            y0, x0 = rng.integers(0, HW - 24, 2)
            mask[y0 : y0 + 20, x0 : x0 + 24] = 0
            stem = f"{grid.lower()}{g:02d}{i:02d}"
            Image.fromarray(img).save(split / "images" / f"{stem}.png")
            Image.fromarray(mask).save(split / "masks" / f"{stem}_mask_resized.png")
    x = jnp.zeros((1, HW, HW, 1))
    variables = jax.jit(JG().init, static_argnums=3)(jax.random.PRNGKey(0), x, x + 1, False)
    (root / "ckpts").mkdir()
    save_pth(root / "ckpts" / "master_checkpoint.pth", {
        "epoch": 3, "generator_state_dict": generator_vars_to_torch_state(jax.device_get(variables))})
    for name in ("jax", "torch"):
        (root / f"config_{name}.yaml").write_text(CONFIG.format(out=f"out_{name}", hw=HW))


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """The tree, evaluated once by each package: (root, port exit code)."""
    root = tmp_path_factory.mktemp("cli")
    write_tree(root)
    mp = pytest.MonkeyPatch()
    mp.chdir(root)
    mp.setenv("EXPERIMENT_MODE", "true")
    try:
        assert jax_run_evaluation_mode(jax_load_config("config_jax.yaml"))
        code = main_pipeline.main(["--mode", "evaluate", "--config", "config_torch.yaml",
                                   "--device", "cpu"])
    finally:
        mp.undo()
    return root, code


def grey(path: Path) -> np.ndarray:
    with Image.open(path) as img:
        return np.asarray(img)


def test_evaluate_is_within_one_grey_level_of_the_jax_cli(evaluated):
    root, code = evaluated
    assert code == 0
    jax_pngs = sorted((root / "out_jax").rglob("*_inpainted.png"))
    assert len(jax_pngs) == len(GRIDS) * TILES
    for p in jax_pngs:
        ours = root / "out_torch" / p.relative_to(root / "out_jax")
        a, b = grey(ours).astype(np.int16), grey(p).astype(np.int16)
        assert a.shape == b.shape == (500, 500)
        assert np.abs(a - b).max() <= 1


def test_colored_pngs_equal_the_jax_colorizers(evaluated, tmp_path):
    from terra_gan_tpu.data.visualization import DSMColorizer as JColorizer

    root, _ = evaluated
    lut = build_lut()
    for grid in GRIDS:
        inpainted = root / "out_torch" / grid / "inpainted"
        ours = sorted((root / "out_torch" / grid / "colored").glob("*.png"))
        theirs = JColorizer(inpainted, tmp_path / grid).recolor_all()
        assert [p.name for p in ours] == [p.name for p in theirs] and len(ours) == TILES
        for o, t in zip(ours, theirs):
            np.testing.assert_array_equal(grey(o), grey(t))
            gray = grey(inpainted / o.name.replace("_colored", ""))
            np.testing.assert_array_equal(grey(o), lut[gray])
            jax_colored = grey(root / "out_jax" / grid / "colored" / o.name)
            same = gray == grey(root / "out_jax" / grid / "inpainted" /
                                o.name.replace("_colored", ""))
            np.testing.assert_array_equal(grey(o)[same], jax_colored[same])


def test_grid_flag_evaluates_one_grid(evaluated, monkeypatch):
    root, _ = evaluated
    monkeypatch.chdir(root)
    (root / "config_one.yaml").write_text(CONFIG.format(out="out_one", hw=HW))
    assert main_pipeline.main(["--mode", "evaluate", "--config", "config_one.yaml",
                               "--grid", GRIDS[1], "--device", "cpu"]) == 0
    assert sorted(p.name for p in (root / "out_one").iterdir()) == [GRIDS[1]]


def test_evaluate_without_a_model_exits_1(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    Path("config.yaml").write_text(CONFIG.format(out="out", hw=HW))
    assert main_pipeline.main(["--mode", "evaluate", "--config", "config.yaml",
                               "--device", "cpu"]) == 1
    assert main_pipeline.main(["--mode", "evaluate", "--config", "config.yaml",
                               "--input_model", "missing.pth", "--device", "cpu"]) == 1


@pytest.mark.parametrize("args,config", [
    (["--mode", "train"], ""),
    (["--mode", "human_guided_train", "--grid", "NJ00"], ""),
    (["--mode", "evaluate", "--mesh", "4x2"], ""),
    (["--mode", "evaluate"], "evaluation:\n  quant: w8a8\n"),
], ids=["train", "human_guided_train", "mesh", "quant"])
def test_what_is_not_ported_exits_2(tmp_path, monkeypatch, capsys, args, config):
    monkeypatch.chdir(tmp_path)
    Path("config.yaml").write_text(config)
    assert main_pipeline.main(args + ["--config", "config.yaml", "--device", "cpu"]) == 2
    assert "not ported yet" in capsys.readouterr().err  # the CLI's own log handler


@pytest.mark.parametrize("dtype", ["bf16", "bfloat16", "BFloat16"])
def test_bf16_compute_dtype_exits_2_and_names_the_key(tmp_path, monkeypatch, capsys, dtype):
    # the JAX CLI builds a bf16 model for these (main_pipeline.py:103-108)
    monkeypatch.chdir(tmp_path)
    Path("config.yaml").write_text(f"training:\n  compute_dtype: {dtype}\n")
    assert main_pipeline.main(["--mode", "evaluate", "--config", "config.yaml",
                               "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "training.compute_dtype" in err and "not ported yet" in err


@pytest.mark.parametrize("dtype", ["float32", None])
def test_fp32_compute_dtype_evaluates(evaluated, monkeypatch, dtype):
    root, _ = evaluated
    monkeypatch.chdir(root)
    cfg = CONFIG.format(out=f"out_{dtype}", hw=HW)
    if dtype is not None:
        cfg += f"training:\n  compute_dtype: {dtype}\n"
    (root / f"config_{dtype}.yaml").write_text(cfg)
    assert main_pipeline.main(["--mode", "evaluate", "--config", f"config_{dtype}.yaml",
                               "--grid", GRIDS[0], "--device", "cpu"]) == 0
    assert len(list((root / f"out_{dtype}" / GRIDS[0] / "inpainted").glob("*.png"))) == TILES


def test_tracking_is_not_ported_and_says_so(evaluated, monkeypatch, capsys):
    root, _ = evaluated
    monkeypatch.chdir(root)
    (root / "config_tracked.yaml").write_text(
        CONFIG.format(out="out_tracked", hw=HW).replace("enabled: false", "enabled: true"))
    assert main_pipeline.main(["--mode", "evaluate", "--config", "config_tracked.yaml",
                               "--device", "cpu"]) == 0
    assert "experiment tracking is not ported yet" in capsys.readouterr().err


def test_docker_env_rebases_the_data_paths(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    Path("config.yaml").write_text(CONFIG.format(out="out", hw=HW))
    monkeypatch.setenv("DOCKER_ENV", "1")
    cfg = main_pipeline._load_config("config.yaml")
    jcfg = jax_load_config("config.yaml")
    for field in ("raw_dir", "processed_dir", "output_dir", "input_zip_folder", "models_dir"):
        assert getattr(cfg.data, field) == getattr(jcfg.data, field)
        assert getattr(cfg.data, field).startswith("/app/")
    assert cfg.data.processed_dir == "/app/data/processed"
    assert cfg.data.extracted_dir == "data/raw_data/extracted"  # not rebased, as in JAX
    monkeypatch.delenv("DOCKER_ENV")
    assert main_pipeline._load_config("config.yaml").data.processed_dir == "data/processed"


def test_missing_config_uses_the_defaults(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    cfg = main_pipeline._load_config("nowhere.yaml")
    assert cfg.data.processed_dir == "data/processed_data" and "not found" in caplog.text
    assert main_pipeline._image_size(cfg) == 512
    assert main_pipeline._master_checkpoint_path(cfg) == Path(
        "mvp_gan/checkpoints/master_checkpoint.pth")


def test_the_default_device_raises_without_cuda(evaluated, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is there")
    root, _ = evaluated
    monkeypatch.chdir(root)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_pipeline.main(["--mode", "evaluate", "--config", "config_torch.yaml"])


def test_python_m_package_runs_the_pipeline(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "terra_gan_tpu_torch", "--mode", "train", "--config", "none.yaml"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 2, out.stderr
    assert "--mode train is not ported yet" in out.stderr


@pytest.mark.parametrize("ref", ["NJ05", "nj05", "NJ5", "NJ0957", "nj0957", "", "N J05", "NJ05x"])
def test_grid_references_are_checked_as_in_jax(ref):
    from terra_gan_tpu.data import paths as jpaths
    from terra_gan_tpu_torch.data import paths

    assert paths.is_valid_parent_grid(ref) == jpaths.is_valid_parent_grid(ref)
    assert paths.is_valid_child_grid(ref) == jpaths.is_valid_child_grid(ref)


def test_path_manager_lays_out_the_jax_tree(tmp_path):
    from terra_gan_tpu.config import Config as JConfig
    from terra_gan_tpu.data.paths import PathManager as JPathManager
    from terra_gan_tpu_torch.config import Config
    from terra_gan_tpu_torch.data.paths import PathManager

    d = {"data": {"processed_dir": str(tmp_path / "p"), "output_dir": str(tmp_path / "o")}}
    ours, theirs = PathManager(Config.from_dict(d)), JPathManager(JConfig.from_dict(d))
    assert ours.create_parent_structure("NJ05") == theirs.create_parent_structure("NJ05")
    assert ours.child_paths("NJ05", "nj0501") == theirs.child_paths("NJ05", "nj0501")
    assert ours.split_dirs("NJ05", "test") == theirs.split_dirs("NJ05", "test")
    assert ours.parent_from_zip("zips/nj05.zip") == "NJ05"
    for pm in (ours, theirs):
        with pytest.raises(ValueError, match="invalid"):
            pm.child_paths("NJ05", "nj05")
        with pytest.raises(ValueError, match="invalid"):
            pm.parent_from_zip("zips/grid.zip")
    assert sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*")) == sorted(
        ["o", "o/NJ05", "p", "p/NJ05"]
        + [f"o/NJ05/{s}" for s in ("inpainted", "colored", "visualization", "masks")]
        + [f"p/NJ05/{s}" for s in ("metadata", "raw", "train", "train/images", "train/masks",
                                   "test", "test/images", "test/masks", "val", "val/images",
                                   "val/masks")])
