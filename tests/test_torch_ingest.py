"""The port's ingest (zip -> DSM PNGs, masks, splits) and batch loader against the JAX package's.

``asc`` must be bitwise the JAX numpy path (the JAX native parser is
switched off here), NODATA, flat and all-NODATA tiles included; the
checkerboard splits equal, and each package reads the other's split
metadata. ``ingest_zip`` runs in both packages on a 3x3 Digimap-style
zip (DSM 64^2 ``.asc``, RGB 128^2 JPEG, as tests/test_cli_pipeline.py
builds it, with structured aerial-like RGB so the detectors find
something): equal raw PNGs, tile registration and splits, and masks
within the detector tests' IoU. ``BatchLoader`` gives the JAX loader's
batch stream with 1 and N producer threads, after ``set_epoch``, with
``drop_last``, and raises under ``strict``; it runs one thread unless
TERRA_GAN_TPU_FEED_WORKERS (or the caller) asks for more.
"""

from __future__ import annotations

import json
import logging
import zipfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from terra_gan_tpu.config import Config as JConfig
from terra_gan_tpu.data import asc as jasc
from terra_gan_tpu.data import ingest as jingest
from terra_gan_tpu.data import parallel as jparallel
from terra_gan_tpu.data import splitting as jsplit
from terra_gan_tpu.data.dataset import BatchLoader as JBatchLoader
from terra_gan_tpu.data.dataset import InpaintingDataset as JInpaintingDataset
from terra_gan_tpu.utils import native
from terra_gan_tpu_torch.config import Config
from terra_gan_tpu_torch.data import asc, ingest, parallel, splitting
from terra_gan_tpu_torch.data.dataset import BatchLoader, InpaintingDataset
from test_torch_detectors import aerial, iou, jpeg_bytes

HW = 64


@pytest.fixture
def numpy_asc(monkeypatch):
    """The JAX package's .asc parse and normalise on their numpy path."""
    monkeypatch.setattr(native, "load_library", lambda: None)


def grids():
    rng = np.random.default_rng(0)
    dem = rng.uniform(0, 120, (70, 50))
    holes = dem.copy()
    holes[rng.random(dem.shape) < 0.2] = np.nan
    holes[:, :3] = np.nan
    return {"dem": dem, "nodata": holes, "flat": np.full((40, 40), 17.25),
            "all_nodata": np.full((30, 20), np.nan)}


@pytest.mark.parametrize("case", ["dem", "nodata", "flat", "all_nodata"])
def test_asc_is_bitwise_the_jax_numpy_path(case, tmp_path, numpy_asc):
    grid = grids()[case]
    asc.write_asc(tmp_path / "t.asc", grid, xllcorner=3.5, cellsize=2.0)
    jasc.write_asc(tmp_path / "j.asc", grid, xllcorner=3.5, cellsize=2.0)
    assert (tmp_path / "t.asc").read_bytes() == (tmp_path / "j.asc").read_bytes()
    got, header = asc.read_asc(tmp_path / "t.asc")
    want, jheader = jasc.read_asc(tmp_path / "t.asc")
    assert header == jheader
    np.testing.assert_array_equal(got, want)
    norm, jnorm = asc.normalize_tile(got), jasc.normalize_tile(want)
    if case == "all_nodata":
        assert norm is None and jnorm is None
    else:
        np.testing.assert_array_equal(norm, jnorm)
    for size in (512, 0):
        made = asc.asc_to_png(tmp_path / "t.asc", tmp_path / f"t{size}.png", size)
        jmade = jasc.asc_to_png(tmp_path / "t.asc", tmp_path / f"j{size}.png", size)
        assert made == jmade == (case != "all_nodata")
        if made:
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"t{size}.png")),
                                          np.asarray(Image.open(tmp_path / f"j{size}.png")))


def test_checkerboard_split_equals_jax():
    for min_x, min_y in ((0, 0), (3, 7), (11, 2)):
        for x in range(min_x, min_x + 10):
            for y in range(min_y, min_y + 10):
                assert (splitting.checkerboard_split(x, y, min_x, min_y)
                        == jsplit.checkerboard_split(x, y, min_x, min_y))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_split_metadata_reads_across_packages(writer, tmp_path):
    made = {"port": splitting.GeographicalSplitter, "jax": jsplit.GeographicalSplitter}
    src = made[writer]("NJ05", tmp_path)
    for x in range(2, 6):
        for y in range(4, 8):
            src.add_tile(tmp_path / f"nj{x:02d}{y:02d}.png", x, y)
    src.generate_splits()
    src.save_metadata()
    for reader in made.values():
        other = reader("NJ05", tmp_path)
        other.load_metadata()
        assert other.assignments == src.assignments
        assert {k: (r.path, r.x, r.y, r.split) for k, r in other.tiles.items()} == {
            k: (r.path, r.x, r.y, r.split) for k, r in src.tiles.items()}
        assert other.get_split_statistics() == src.get_split_statistics() == {
            "train": 5, "val": 5, "test": 6}


def test_parallel_helpers_match_jax(caplog):
    def square(v, offset=0):
        if v % 5 == 3:
            raise ValueError(f"bad {v}")
        return v * v + offset

    items = list(range(23))
    with caplog.at_level(logging.ERROR):
        got = parallel.process_images_in_parallel(items, square, max_workers=4, offset=1)
    assert sorted(got) == sorted(jparallel.process_images_in_parallel(items, square, offset=1))
    assert sum("processing failed" in r.message for r in caplog.records
               if r.name == parallel.logger.name) == 4
    assert (sorted(parallel.batch_process(items, square, batch_size=5, max_workers=2))
            == sorted(jparallel.batch_process(items, square, batch_size=5)))
    assert parallel.default_workers() == jparallel.default_workers()


# ------------------------------------------------------------- ingest ----

def write_zip(root: Path, seed: int = 0) -> Path:
    rng = np.random.default_rng(seed)
    src = root / "src"
    dsm, rgb = src / "getmapping-dsm-2000_x", src / "getmapping_rgb_25cm_x"
    dsm.mkdir(parents=True)
    rgb.mkdir(parents=True)
    for x in range(3):
        for y in range(3):
            name = f"nj{x:02d}{y:02d}"
            asc.write_asc(dsm / f"{name}_DSM.asc", rng.uniform(0, 100, (HW, HW)))
            (rgb / f"{name}_rgb.jpg").write_bytes(jpeg_bytes(aerial(128, 128, 10 * x + y)))
    (src / "readme.txt").write_text("not extracted")
    path = root / "NJ00.zip"
    with zipfile.ZipFile(path, "w") as zf:
        for p in src.rglob("*"):
            if p.is_file():
                zf.write(p, p.relative_to(src))
    return path


def config_dict(work: Path) -> dict:
    return {
        "mask_processing": {"visualization": {"enabled": False}},
        "data": {key: str(work / key) for key in
                 ("raw_dir", "processed_dir", "output_dir", "models_dir")},
    }


@pytest.fixture(scope="module")
def ingested(tmp_path_factory):
    """The same zip ingested by the JAX package and by the port (on the CPU)."""
    root = tmp_path_factory.mktemp("ingest")
    zip_path = write_zip(root)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "load_library", lambda: None)
        for name, cfg_cls, mod, split_mod, kw in (
            ("jax", JConfig, jingest, jsplit, {}),
            ("port", Config, ingest, splitting, {"device": "cpu"}),
        ):
            work = root / name
            cfg = cfg_cls.from_dict(config_dict(work))
            splitter = split_mod.GeographicalSplitter("NJ00", work / "processed_dir")
            ok = mod.ingest_zip(zip_path, "nj00", cfg, splitter=splitter, **kw)
            splitter.generate_splits()
            splitter.apply_splits()
            splitter.save_metadata()
            out[name] = (ok, work, splitter)
    return out


def test_ingest_zip_writes_the_jax_tiles(ingested):
    (jok, jwork, jsp), (ok, work, sp) = ingested["jax"], ingested["port"]
    assert ok and jok
    raw, jraw = work / "processed_dir/NJ00/raw", jwork / "processed_dir/NJ00/raw"
    names = sorted(p.name for p in raw.iterdir())
    assert names == sorted(p.name for p in jraw.iterdir()) and len(names) == 18
    for name in names:
        got = np.asarray(Image.open(raw / name))
        want = np.asarray(Image.open(jraw / name))
        assert got.shape == want.shape == ((512, 512) if "mask" not in name else (128, 128))
        if name.endswith("_mask_resized.png"):
            assert iou(got == 0, want == 0) >= 0.95 and set(np.unique(got)) <= {0, 255}
        else:
            np.testing.assert_array_equal(got, want)
    assert not (work / "raw_dir/NJ00_extracted").exists()  # cleanup_extracted


def test_ingest_zip_registers_and_splits_as_jax(ingested):
    (_, jwork, jsp), (_, work, sp) = ingested["jax"], ingested["port"]
    assert sorted(sp.tiles) == sorted(jsp.tiles) == [(x, y) for x in range(3) for y in range(3)]
    assert {k: r.path.name for k, r in sp.tiles.items()} == {
        k: r.path.name for k, r in jsp.tiles.items()}
    assert sp.assignments == jsp.assignments
    assert sp.get_split_statistics() == {"train": 3, "val": 3, "test": 3}
    for split in ("train", "val", "test"):
        for kind in ("images", "masks"):
            d, jd = (w / "processed_dir/NJ00" / split / kind for w in (work, jwork))
            assert sorted(p.name for p in d.iterdir()) == sorted(p.name for p in jd.iterdir())
    meta = json.loads((work / "processed_dir/NJ00/metadata/split_mapping.json").read_text())
    jmeta = json.loads((jwork / "processed_dir/NJ00/metadata/split_mapping.json").read_text())
    assert meta == jmeta


def test_ingest_helpers_match_jax(tmp_path):
    for name in ("nj0957", "NJ0957", "nj095", "xx1234", "n10957"):
        assert ingest.parse_tile_xy(name) == jingest.parse_tile_xy(name)
    zip_path = write_zip(tmp_path)
    assert ingest.extract_target_folders(zip_path, tmp_path / "a")
    assert jingest.extract_target_folders(zip_path, tmp_path / "b")
    files = sorted(str(p.relative_to(tmp_path / "a")) for p in (tmp_path / "a").rglob("*"))
    assert files == sorted(str(p.relative_to(tmp_path / "b")) for p in (tmp_path / "b").rglob("*"))
    assert not any("readme" in f for f in files)
    assert not ingest.extract_target_folders(tmp_path / "missing.zip", tmp_path / "c")


# --------------------------------------------------------- BatchLoader ----

def write_tiles(root: Path, n: int, seed: int, size: int = 72):
    rng = np.random.default_rng(seed)
    images, masks = root / "images", root / "masks"
    images.mkdir(parents=True)
    masks.mkdir(parents=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size), dtype=np.uint8)).save(
            images / f"t{i:02d}.png")
        Image.fromarray((rng.random((size, size)) > 0.3).astype(np.uint8) * 255).save(
            masks / f"t{i:02d}.png")
    return images, masks


def datasets(images, masks):
    return (InpaintingDataset(images, masks, size=HW),
            JInpaintingDataset(images, masks, size=HW, cache_bytes=0))


def assert_same_stream(got, want):
    assert [b["image"].shape[0] for b in got] == [b["image"].shape[0] for b in want]
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("workers", [1, 3])
def test_batch_loader_streams_the_jax_batches_with_n_workers(workers, tmp_path):
    ours, theirs = datasets(*write_tiles(tmp_path, 11, seed=1))
    got = BatchLoader(ours, 4, seed=5, num_workers=workers)
    want = JBatchLoader(theirs, 4, seed=5, num_workers=1)
    assert len(got) == len(want) == 3
    for _ in range(3):
        assert_same_stream(list(got), list(want))


def test_batch_loader_set_epoch_and_drop_last_as_jax(tmp_path):
    ours, theirs = datasets(*write_tiles(tmp_path, 10, seed=2))
    straight = BatchLoader(ours, 4, seed=9, num_workers=2)
    epochs = [list(straight) for _ in range(3)]
    resumed = BatchLoader(ours, 4, seed=9, num_workers=2)
    resumed.set_epoch(2)
    assert_same_stream(list(resumed), epochs[2])
    jresumed = JBatchLoader(theirs, 4, seed=9, num_workers=1)
    jresumed.set_epoch(2)
    assert_same_stream(epochs[2], list(jresumed))
    dropped = BatchLoader(ours, 4, seed=9, drop_last=True, num_workers=3)
    jdropped = JBatchLoader(theirs, 4, seed=9, drop_last=True, num_workers=1)
    assert len(dropped) == len(jdropped) == 2
    got = list(dropped)
    assert [b["image"].shape[0] for b in got] == [4, 4]
    assert_same_stream(got, list(jdropped))


def test_batch_loader_strict_raises_where_the_default_skips(tmp_path, caplog):
    images, masks = write_tiles(tmp_path, 6, seed=3)
    (images / "t03.png").write_bytes(b"not a png")
    ours, theirs = datasets(images, masks)
    with caplog.at_level(logging.ERROR):
        kept = list(BatchLoader(ours, 2, shuffle=False, num_workers=2))
    assert len(kept) == 2 and "batch load failed" in caplog.text
    for loader in (BatchLoader(ours, 2, shuffle=False, strict=True, num_workers=2),
                   JBatchLoader(theirs, 2, shuffle=False, strict=True, num_workers=1)):
        with pytest.raises(RuntimeError, match="strict"):
            list(loader)


def test_batch_loader_keeps_order_under_thread_pressure(tmp_path):
    """16 producers (more than cores) and a short switch interval: the stream
    is still the single producer's, batch for batch."""
    import sys

    ours, _ = datasets(*write_tiles(tmp_path, 24, seed=6, size=HW))
    want = list(BatchLoader(ours, 2, seed=3, num_workers=1))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = list(BatchLoader(ours, 2, seed=3, num_workers=16, prefetch=1))
    finally:
        sys.setswitchinterval(interval)
    assert_same_stream(got, want)


def test_batch_loader_workers_stop_when_the_consumer_does(tmp_path):
    ours, _ = datasets(*write_tiles(tmp_path, 12, seed=4))
    loader = BatchLoader(ours, 2, seed=0, num_workers=4, prefetch=1)
    it = iter(loader)
    next(it)
    it.close()  # the generator's finally joins its producer threads
    import threading

    assert not [t for t in threading.enumerate() if t.name == "batch-loader"]


@pytest.mark.parametrize("env, want", [(None, 1), ("3", 3), ("0", 1), ("x", 1)])
def test_default_feed_workers_is_one_unless_set(env, want, monkeypatch, tmp_path):
    """One producer thread by default (one card's step outlasts a batch's
    decode); TERRA_GAN_TPU_FEED_WORKERS sets the count, as in JAX."""
    from terra_gan_tpu_torch.data.dataset import default_feed_workers

    if env is None:
        monkeypatch.delenv("TERRA_GAN_TPU_FEED_WORKERS", raising=False)
    else:
        monkeypatch.setenv("TERRA_GAN_TPU_FEED_WORKERS", env)
    assert default_feed_workers() == want
    ours, _ = datasets(*write_tiles(tmp_path, 4, seed=7))
    assert BatchLoader(ours, 2).num_workers == want
