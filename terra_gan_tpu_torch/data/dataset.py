"""Training tiles and the batch loader (counterpart of terra_gan_tpu/data/dataset.py).

Reference contracts:
  * InpaintingDataset (mvp_gan/src/utils/dataset.py:14-43,
    train.py:67-81): paired image and mask directories, matched by sorted
    filename; both grayscale and resized to ``size`` with PIL's bilinear
    filter (the same transform for the mask); the mask binarised at > 0
    after the resize; values scaled to [0, 1].
  * DirectMatchDataset (direct_match_dataset.py:31-85): (image, system
    mask, human mask) triplets from matched-pair dicts; the image resized
    bilinear, both masks NEAREST, binarised at > 0.5; an unreadable item
    becomes zeros with tile_name "error".

Both keep the decoded uint8 planes in a ``_TileCache``, so later epochs
pay array math, not PNG decode. ``BatchLoader`` is the JAX package's
loader, so both give the same batch stream for the same seed. Batches
are NHWC float32 numpy arrays (other fields, such as tile_name, lists).

Re-implemented here because the JAX package's data modules import its
config, which needs ``yaml``, and its image helpers, ``cv2``. Producer
threads decode the next batches while the device computes.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

logger = logging.getLogger(__name__)

TARGET = 512

# Decoded-tile cache budget (the JAX package's): a cached 512^2 pair is
# about 512 KB of uint8 planes, so the 256 MB default holds about 500
# tiles, every real parent split. TERRA_GAN_TPU_TILE_CACHE_MB sets
# another budget (0 disables).
DEFAULT_CACHE_BYTES = 256 * 2**20


def _cache_budget() -> int:
    env = os.environ.get("TERRA_GAN_TPU_TILE_CACHE_MB")
    if env is not None:
        try:
            return int(float(env) * 2**20)
        except ValueError:
            logger.warning("bad TERRA_GAN_TPU_TILE_CACHE_MB=%r ignored", env)
    return DEFAULT_CACHE_BYTES


class _TileCache:
    """Insert-until-full cache of decoded uint8 tile tuples.

    An epoch reads every index once, the pattern on which an LRU evicts
    each entry just before its next use; filling to the budget and then
    keeping what is there serves the first ``budget`` bytes of tiles from
    memory every epoch and leaves the rest on the decode path.
    """

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self.used = 0
        self._data: Dict[int, Tuple[np.ndarray, ...]] = {}
        self._lock = threading.Lock()

    def get(self, key: int) -> Optional[Tuple[np.ndarray, ...]]:
        return self._data.get(key)

    def put(self, key: int, arrays: Tuple[np.ndarray, ...]) -> None:
        nbytes = sum(a.nbytes for a in arrays)
        with self._lock:
            if key in self._data or self.used + nbytes > self.budget:
                return
            self._data[key] = arrays
            self.used += nbytes


def _new_cache() -> Optional[_TileCache]:
    budget = _cache_budget()
    return _TileCache(budget) if budget > 0 else None


def _load_gray_u8(path: str | Path, size: int, resample=Image.BILINEAR) -> np.ndarray:
    """The (size, size) uint8 plane after the resize: the cacheable form,
    since the float conversion comes after it."""
    with Image.open(path) as img:
        img = img.convert("L")
        if img.size != (size, size):
            img = img.resize((size, size), resample)
        return np.asarray(img, np.uint8)


def _unit(u8: np.ndarray) -> np.ndarray:
    return u8.astype(np.float32)[..., None] / 255.0


def _plane(u8: np.ndarray) -> np.ndarray:
    return u8.astype(np.float32)[..., None]


class InpaintingDataset:
    """Paired image/mask directories, index-aligned by sorted filename."""

    def __init__(self, img_dir: str | Path, mask_dir: str | Path, size: int = TARGET):
        self.size = size
        self.img_files = sorted(p for p in Path(img_dir).iterdir() if p.is_file())
        self.mask_files = sorted(p for p in Path(mask_dir).iterdir() if p.is_file())
        if len(self.img_files) != len(self.mask_files):
            raise ValueError(
                f"image/mask count mismatch: {len(self.img_files)} vs {len(self.mask_files)}"
            )
        self._cache = _new_cache()

    def __len__(self) -> int:
        return len(self.img_files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cached = self._cache.get(idx) if self._cache else None
        if cached is None:
            img = _load_gray_u8(self.img_files[idx], self.size)
            # the reference resizes the mask with the same bilinear
            # transform, then binarises at > 0 (dataset.py:37)
            mask = (_load_gray_u8(self.mask_files[idx], self.size) > 0).astype(np.uint8)
            if self._cache:
                self._cache.put(idx, (img, mask))
        else:
            img, mask = cached
        return {"image": _unit(img), "mask": _plane(mask)}


class DirectMatchDataset:
    """Triplets for human-guided fine-tuning from matched-pair dicts
    (``tile_name``, ``image_path``, ``system_mask_path``, ``human_mask_path``)."""

    def __init__(self, matched_pairs: Sequence[Dict], size: int = TARGET):
        self.pairs = list(matched_pairs)
        self.size = size
        self._cache = _new_cache()

    def __len__(self) -> int:
        return len(self.pairs)

    def _decode(self, pair: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        image = _load_gray_u8(pair["image_path"], self.size, Image.BILINEAR)
        # binarised at > 0.5 on the [0, 1] scale (direct_match_dataset.py:54-61):
        # on the resized uint8 plane that is u8 >= 128
        system = (_load_gray_u8(pair["system_mask_path"], self.size, Image.NEAREST)
                  >= 128).astype(np.uint8)
        human = (_load_gray_u8(pair["human_mask_path"], self.size, Image.NEAREST)
                 >= 128).astype(np.uint8)
        if human.sum() == 0:
            logger.warning("human mask for tile %s is empty", pair.get("tile_name"))
        return image, system, human

    def __getitem__(self, idx: int) -> Dict:
        pair = self.pairs[idx]
        cached = self._cache.get(idx) if self._cache else None
        if cached is None:
            try:
                cached = self._decode(pair)
            except Exception as e:
                logger.error("failed to load item %d: %s", idx, e)
                zero = np.zeros((self.size, self.size, 1), np.float32)
                return {"image": zero, "mask": zero, "human_mask": zero, "tile_name": "error"}
            # an error item is never cached: a transient read failure heals later
            if self._cache:
                self._cache.put(idx, cached)
        image, system, human = cached
        return {"image": _unit(image), "mask": _plane(system), "human_mask": _plane(human),
                "tile_name": pair.get("tile_name", "")}


def default_feed_workers() -> int:
    """Producer threads for BatchLoader: TERRA_GAN_TPU_FEED_WORKERS where it
    is set (as in the JAX package), else one.

    The JAX package defaults to min(4, cores) to feed a mesh of chips. One
    card's train step takes a batch of 8 512^2 tiles in 200-250 ms, and one
    producer decodes the batch well within that (masks at 2000^2
    included); more threads only take the interpreter lock from the step's
    launches. On an NVIDIA H100 an epoch of 8 steps took 2-4 % longer with
    4 producers than with 1 (``profile_slice.py --legs epoch``). The batch
    stream is the same with any count.
    """
    env = os.environ.get("TERRA_GAN_TPU_FEED_WORKERS")
    if env is not None:
        try:
            return max(1, int(env))
        except ValueError:
            logger.warning("bad TERRA_GAN_TPU_FEED_WORKERS=%r ignored", env)
    return 1


class _Failed:
    def __init__(self, error: Exception):
        self.error = error


class BatchLoader:
    """Shuffling batcher with N producer threads; yields {key: [B, ...]} batches.

    The JAX package's loader (terra_gan_tpu/data/dataset.py:238-407):
    NHWC float32 arrays stacked (other fields collected into lists);
    the partial last batch kept unless ``drop_last``; one permutation per
    epoch from ``np.random.default_rng(seed)``, and ``set_epoch`` to
    fast-forward that stream after a resume. Workers claim batch indices
    from a shared counter and publish into a reorder buffer that the
    consumer empties strictly in sequence, so the same seed gives the
    same batch stream with 1 or N workers. A batch that fails to load is
    logged and skipped (``strict``: raises instead); an epoch in which
    every batch failed raises.

    Three process-wide counters, read as the difference of two readings
    like the kernels' ``.launches``: ``batches`` yielded, ``ready``, those
    of them already made when the consumer first asked (no wait), and
    ``make_s``, the feed threads' host seconds of decode and collate. Each
    is updated under the iteration's lock; two loaders iterated at once
    from different threads may lose an update.
    """

    batches = 0
    ready = 0
    make_s = 0.0

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        strict: bool = False,
        num_workers: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.strict = strict
        self.num_workers = (
            default_feed_workers() if num_workers is None else max(1, num_workers)
        )
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def set_epoch(self, epoch: int) -> None:
        """Fast-forward the shuffle stream to epoch ``epoch``: the next
        ``__iter__`` gives the order that epoch has in an uninterrupted
        run (one permutation drawn and discarded per skipped epoch)."""
        while self._epoch < epoch:
            self._order()
            self._epoch += 1

    @staticmethod
    def _collate(items: List[Dict]) -> Dict:
        out: Dict = {}
        for key in items[0]:
            vals = [it[key] for it in items]
            out[key] = np.stack(vals, axis=0) if isinstance(vals[0], np.ndarray) else vals
        return out

    def __iter__(self) -> Iterator[Dict]:
        order = self._order()
        self._epoch += 1
        n = len(order)
        bs = self.batch_size
        stops = range(0, n - bs + 1, bs) if self.drop_last else range(0, n, bs)
        batches = [order[s : s + bs] for s in stops]
        total = len(batches)
        workers = max(1, min(self.num_workers, total)) if total else 0

        # at most emit + prefetch + workers batches are claimed ahead of the
        # consumer, so memory stays bounded however slow it is
        results: Dict[int, object] = {}
        cond = threading.Condition()
        state = {"claim": 0, "emit": 0, "stop": False}
        max_ahead = self.prefetch + workers

        def worker():
            while True:
                with cond:
                    while (not state["stop"] and state["claim"] < total
                           and state["claim"] >= state["emit"] + max_ahead):
                        cond.wait()
                    if state["stop"] or state["claim"] >= total:
                        return
                    seq = state["claim"]
                    state["claim"] += 1
                t0 = time.perf_counter()
                try:
                    out: object = self._collate([self.dataset[int(i)] for i in batches[seq]])
                except Exception as e:
                    if not self.strict:  # a bad tile skips its batch, not the epoch
                        logger.error("batch load failed, skipping: %s", e)
                    out = _Failed(e)
                made = time.perf_counter() - t0
                with cond:
                    results[seq] = out
                    BatchLoader.make_s += made
                    cond.notify_all()

        threads = [threading.Thread(target=worker, name="batch-loader", daemon=True)
                   for _ in range(workers)]
        for t in threads:
            t.start()
        last_err, produced = None, 0
        try:
            for seq in range(total):
                with cond:
                    ready = seq in results
                    while seq not in results:
                        cond.wait()
                    item = results.pop(seq)
                    state["emit"] = seq + 1
                    if not isinstance(item, _Failed):
                        BatchLoader.batches += 1
                        BatchLoader.ready += ready
                    cond.notify_all()
                if isinstance(item, _Failed):
                    if self.strict:
                        raise RuntimeError("batch load failed in strict mode") from item.error
                    last_err = item.error
                    continue
                produced += 1
                yield item
            if total and produced == 0 and last_err is not None:
                raise RuntimeError("every batch failed to load") from last_err
        finally:
            with cond:
                state["stop"] = True
                cond.notify_all()
            for t in threads:
                t.join()

