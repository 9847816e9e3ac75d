"""The port's human-guided loss, DirectMatchDataset, tile cache and annotation validator against the JAX package.

Same numpy inputs from seeds. The loss (64^2, batch 3, the JAX package's
``random_weights(0)`` VGG carried across) is held to 1e-6 relative in
fp32 for a human mask that is None, all empty, partly empty (some items
empty), sparse or full, at boundary weight 0, 0.5 and missing (read from
the YAML through ``hg_loss_config``). Dataset items and validator
outputs are held bitwise.
"""

from __future__ import annotations

import json
import logging
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from terra_gan_tpu.config import Config as JConfig
from terra_gan_tpu.data import annotation_validator as jvalidator
from terra_gan_tpu.data import dataset as jdataset
from terra_gan_tpu.losses import human_guided_loss as j_human_guided_loss
from terra_gan_tpu.models.vgg import random_weights
from terra_gan_tpu.training.human_guided import hg_loss_config as j_hg_loss_config
from terra_gan_tpu_torch.config import Config
from terra_gan_tpu_torch.data import annotation_validator as validator
from terra_gan_tpu_torch.data import dataset
from terra_gan_tpu_torch.losses import human_guided_loss
from terra_gan_tpu_torch.training.human_guided import hg_loss_config
from terra_gan_tpu_torch.utils.weights import vgg_from_jax_params

LOSS_REL_TOL = 1e-6
HW, B = 64, 3


@pytest.fixture(scope="module")
def vggs():
    params = [(np.asarray(k), np.asarray(b)) for k, b in random_weights(0)]
    return random_weights(0), vgg_from_jax_params(params, "cpu")


def loss_inputs(human: str):
    rng = np.random.default_rng(11)
    pred = rng.random((B, HW, HW, 1), dtype=np.float32)
    target = rng.random((B, HW, HW, 1), dtype=np.float32)
    mask = (rng.random((B, HW, HW, 1)) > 0.3).astype(np.float32)
    mask[:, 10:30, 20:44] = 0.0
    hmask = {
        "none": None,
        "empty": np.zeros((B, HW, HW, 1), np.float32),
        "partly_empty": np.concatenate([np.zeros((1, HW, HW, 1), np.float32),
                                        (rng.random((B - 1, HW, HW, 1)) > 0.8)
                                        .astype(np.float32)]),
        "sparse": (rng.random((B, HW, HW, 1)) > 0.9).astype(np.float32) * 0.7,
        "full": np.ones((B, HW, HW, 1), np.float32),
    }[human]
    return pred, target, mask, hmask


def yaml_config(boundary: str) -> dict:
    lw = {"perceptual": 0.1, "tv": 0.1}
    if boundary != "missing":
        lw["boundary"] = None if boundary == "null" else float(boundary)
    return {"training": {"loss_weights": lw, "modes": {"human_guided": {
        "base_loss_weight": 0.6, "human_feedback_weight": 0.4}}}}


@pytest.mark.parametrize("boundary", ["0", "0.5", "missing"])
@pytest.mark.parametrize("human", ["none", "empty", "partly_empty", "sparse", "full"])
def test_human_guided_loss_matches_jax(vggs, human, boundary):
    raw = yaml_config(boundary)
    cfg, jcfg = hg_loss_config(Config.from_dict(raw)), j_hg_loss_config(JConfig.from_dict(raw))
    pred, target, mask, hmask = loss_inputs(human)
    jtotal, jcomps = j_human_guided_loss(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask),
        None if hmask is None else jnp.asarray(hmask), vggs[0], jcfg)
    t = torch.from_numpy
    total, comps = human_guided_loss(t(pred), t(target), t(mask),
                                     None if hmask is None else t(hmask), vggs[1], cfg)
    assert set(comps) == set(jcomps)
    for k, v in jcomps.items():
        want = float(v)
        assert abs(comps[k].item() - want) <= LOSS_REL_TOL * max(abs(want), 1e-12), (k, want)
    assert abs(total.item() - float(jtotal)) <= LOSS_REL_TOL * abs(float(jtotal))
    if human in ("none", "empty"):
        assert comps["human"].item() == 0.0 and float(jcomps["human"]) == 0.0
    else:
        assert comps["human"].item() > 0.0


@pytest.mark.parametrize("boundary", ["0", "0.5", "missing", "null"])
def test_hg_loss_config_reads_the_yaml_boundary_as_jax_does(boundary):
    raw = yaml_config(boundary)
    cfg, jcfg = hg_loss_config(Config.from_dict(raw)), j_hg_loss_config(JConfig.from_dict(raw))
    assert cfg.base.boundary_weight == jcfg.base.boundary_weight == (
        0.0 if boundary == "0" else 0.5)
    assert (cfg.base.perceptual_weight, cfg.base.tv_weight, cfg.base_loss_weight,
            cfg.human_feedback_weight) == (jcfg.base.perceptual_weight, jcfg.base.tv_weight,
                                           jcfg.base_loss_weight, jcfg.human_feedback_weight)
    # initial training ignores the YAML's boundary weight (faithful_boundary_default)
    assert Config.from_dict(raw).training.effective_boundary_weight() == 0.5


def test_empty_human_term_leaks_no_gradient():
    pred, target, mask, hmask = loss_inputs("empty")
    p = torch.from_numpy(pred).requires_grad_()
    total, comps = human_guided_loss(p, torch.from_numpy(target), torch.from_numpy(mask),
                                     torch.from_numpy(hmask), None)
    total.backward()
    assert comps["human"].item() == 0.0
    assert torch.isfinite(p.grad).all()
    base_only = torch.from_numpy(pred).requires_grad_()
    t2, _ = human_guided_loss(base_only, torch.from_numpy(target), torch.from_numpy(mask),
                              None, None)
    t2.backward()
    assert torch.equal(p.grad, base_only.grad)


# --- DirectMatchDataset and the tile cache -----------------------------------

def write_png(path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)
    return path


def triplets(root, kind: str, n: int = 3):
    rng = np.random.default_rng(5)
    side = {"native": (HW, HW, HW), "resized": (80, 48, 100)}.get(kind, (HW, HW, HW))
    pairs = []
    for i in range(n):
        tile = f"nj00{i:02d}"
        img = rng.integers(0, 256, (side[0], side[0]), dtype=np.uint8)
        if kind == "rgb":
            img = rng.integers(0, 256, (HW, HW, 3), dtype=np.uint8)
        smask = ((rng.random((side[1], side[1])) > 0.4) * 255).astype(np.uint8)
        hmask = ((rng.random((side[2], side[2])) > 0.8) * 255).astype(np.uint8)
        if kind == "grey_masks":  # values on both sides of 128
            smask = rng.integers(0, 256, (HW, HW), dtype=np.uint8)
            hmask = rng.integers(100, 160, (HW, HW), dtype=np.uint8)
        pairs.append({"tile_name": tile,
                      "image_path": write_png(root / "images" / f"{tile}.png", img),
                      "system_mask_path": write_png(root / "masks" / f"{tile}_mask_resized.png",
                                                    smask),
                      "human_mask_path": write_png(root / "human" / f"c_{tile}_u.png", hmask)})
    return pairs


def assert_items_equal(ours: dict, theirs: dict):
    assert set(ours) == set(theirs)
    assert ours["tile_name"] == theirs["tile_name"]
    for k in ("image", "mask", "human_mask"):
        assert ours[k].dtype == theirs[k].dtype == np.float32
        assert np.array_equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("kind", ["native", "resized", "rgb", "grey_masks"])
def test_direct_match_items_equal_jax(tmp_path, kind):
    pairs = triplets(tmp_path, kind)
    ours = dataset.DirectMatchDataset(pairs, size=HW)
    theirs = jdataset.DirectMatchDataset(pairs, size=HW, cache_bytes=0)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        assert_items_equal(ours[i], theirs[i])
        assert ours[i]["image"].shape == (HW, HW, 1)


def test_direct_match_error_item_is_zeros_and_never_cached(tmp_path, caplog):
    pairs = triplets(tmp_path, "native")
    pairs[1]["image_path"] = tmp_path / "missing.png"
    ours = dataset.DirectMatchDataset(pairs, size=HW)
    theirs = jdataset.DirectMatchDataset(pairs, size=HW, cache_bytes=0)
    with caplog.at_level(logging.ERROR):
        item = ours[1]
    assert_items_equal(item, theirs[1])
    assert item["tile_name"] == "error" and not item["image"].any()
    assert "failed to load item 1" in caplog.text
    assert ours._cache.get(1) is None
    shutil.copy(pairs[0]["image_path"], pairs[1]["image_path"])  # the read heals
    assert ours[1]["tile_name"] == "nj0001" and ours._cache.get(1) is not None


def test_direct_match_cache_hits_equal_misses(tmp_path):
    pairs = triplets(tmp_path, "resized")
    cached = dataset.DirectMatchDataset(pairs, size=HW)
    uncached = jdataset.DirectMatchDataset(pairs, size=HW, cache_bytes=0)
    first = [cached[i] for i in range(3)]
    for i in range(3):
        assert_items_equal(first[i], uncached[i])
    assert cached._cache.used == 3 * 3 * HW * HW
    for p in tmp_path.rglob("*.png"):  # a hit reads no file
        p.unlink()
    for i in range(3):
        assert_items_equal(cached[i], first[i])
    assert uncached[0]["tile_name"] == "error"  # the files are gone


def test_inpainting_dataset_cache_hits_equal_jax(tmp_path):
    rng = np.random.default_rng(9)
    for i in range(3):
        write_png(tmp_path / "img" / f"t{i}.png", rng.integers(0, 256, (80, 80), dtype=np.uint8))
        write_png(tmp_path / "msk" / f"t{i}.png",
                  ((rng.random((70, 70)) > 0.5) * 255).astype(np.uint8))
    ours = dataset.InpaintingDataset(tmp_path / "img", tmp_path / "msk", size=HW)
    theirs = jdataset.InpaintingDataset(tmp_path / "img", tmp_path / "msk", size=HW,
                                        cache_bytes=0)
    misses = [ours[i] for i in range(3)]
    hits = [ours[i] for i in range(3)]
    assert ours._cache.used == 3 * 2 * HW * HW
    for m, h, j in zip(misses, hits, (theirs[i] for i in range(3))):
        for k in ("image", "mask"):
            assert np.array_equal(m[k], j[k]) and np.array_equal(h[k], j[k])


@pytest.mark.parametrize("env", [None, "0", "1.5", "bad", "4"])
def test_cache_budget_matches_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("TERRA_GAN_TPU_TILE_CACHE_MB", raising=False)
    else:
        monkeypatch.setenv("TERRA_GAN_TPU_TILE_CACHE_MB", env)
    assert dataset._cache_budget() == jdataset._cache_budget(None)
    assert (dataset._new_cache() is None) == (jdataset._cache_budget(None) <= 0)


def test_tile_cache_fills_until_its_budget():
    cache = dataset._TileCache(100)
    a = (np.zeros(60, np.uint8),)
    cache.put(0, a)
    cache.put(1, a)  # over the budget: kept out
    cache.put(0, (np.ones(10, np.uint8),))  # present: not replaced
    assert cache.get(0) is a and cache.get(1) is None and cache.used == 60


def test_load_gray_u8_takes_the_resample_filter(tmp_path):
    rng = np.random.default_rng(3)
    p = write_png(tmp_path / "m.png", ((rng.random((50, 50)) > 0.5) * 255).astype(np.uint8))
    near = dataset._load_gray_u8(p, HW, Image.NEAREST)
    assert set(np.unique(near)) <= {0, 255}
    assert np.array_equal(near, jdataset._load_gray_u8(p, HW, Image.NEAREST))
    assert np.array_equal(dataset._load_gray_u8(p, HW),
                          jdataset._load_gray_u8(p, HW, Image.BILINEAR))


# --- the annotation validator ------------------------------------------------

def annotation_tree(root):
    rng = np.random.default_rng(4)
    for i, side in enumerate((HW, 60, 40, HW)):  # exact, within 10 %, outside, exact
        tile = f"nj01{i:02d}"
        human = rng.integers(0, 256, (side, side), dtype=np.uint8)  # not binary
        write_png(root / "human" / f"colored_{tile}_u{i}.png", human)
        write_png(root / "system" / f"{tile}_mask_resized.png",
                  ((rng.random((side, side)) > 0.5) * 255).astype(np.uint8))
    write_png(root / "human" / "colored_nj0199_u.png", np.zeros((HW, HW), np.uint8))  # no system


@pytest.mark.parametrize("mode", ["strict", "resize"])
def test_annotation_validator_writes_what_jax_writes(tmp_path, mode):
    annotation_tree(tmp_path)
    humans = sorted((tmp_path / "human").glob("*.png"))
    systems = sorted((tmp_path / "system").glob("*_mask_resized.png"))
    ours = validator.AnnotationValidator((HW, HW), resize_mode=mode).validate_and_filter_pairs(
        humans, systems, tmp_path / "ours")
    theirs = jvalidator.AnnotationValidator((HW, HW), resize_mode=mode).validate_and_filter_pairs(
        humans, systems, tmp_path / "theirs")
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(theirs))
    assert ours["valid_pairs"] == (3 if mode == "strict" else 4)
    assert (json.loads((tmp_path / "ours" / "validation_metadata.json").read_text())
            == json.loads((tmp_path / "theirs" / "validation_metadata.json").read_text()))
    for sub in ("images", "masks"):
        names = sorted(p.name for p in (tmp_path / "theirs" / sub).iterdir())
        assert sorted(p.name for p in (tmp_path / "ours" / sub).iterdir()) == names
        for n in names:
            assert np.array_equal(np.asarray(Image.open(tmp_path / "ours" / sub / n)),
                                  np.asarray(Image.open(tmp_path / "theirs" / sub / n)))


def test_validate_annotations_counts_as_jax(tmp_path):
    annotation_tree(tmp_path)
    args = (tmp_path / "human", tmp_path / "system")
    assert validator.validate_annotations(*args, tmp_path / "o", (HW, HW)) == \
        jvalidator.validate_annotations(*args, tmp_path / "t", (HW, HW)) == 4
    with pytest.raises(ValueError):
        validator.AnnotationValidator(resize_mode="crop")
