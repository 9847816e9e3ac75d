"""Training tiles and the batch loader (counterpart of terra_gan_tpu/data/dataset.py).

Reference contract (mvp_gan/src/utils/dataset.py:14-43, train.py:67-81):
paired image and mask directories, matched by sorted filename; both
grayscale and resized to ``size`` with PIL's bilinear filter (the same
transform for the mask); the mask binarised at > 0 after the resize;
values scaled to [0, 1]. The loader shuffles with one permutation per
epoch from ``np.random.default_rng(seed)`` and keeps the partial last
batch, as the JAX package's ``BatchLoader`` does, so both give the same
batch stream for the same seed. Batches are NHWC float32 numpy arrays.

Re-implemented here because the JAX package's data modules import its
config, which needs ``yaml``, and its image helpers, ``cv2``. One
prefetch thread decodes the next batches while the device computes.
"""

from __future__ import annotations

import logging
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np

logger = logging.getLogger(__name__)


def _load_gray_u8(path: Path, size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("L")
        if img.size != (size, size):
            img = img.resize((size, size), Image.BILINEAR)
        return np.asarray(img, np.uint8)


class InpaintingDataset:
    """Paired image/mask directories, index-aligned by sorted filename."""

    def __init__(self, img_dir: str | Path, mask_dir: str | Path, size: int = 512):
        self.size = size
        self.img_files = sorted(p for p in Path(img_dir).iterdir() if p.is_file())
        self.mask_files = sorted(p for p in Path(mask_dir).iterdir() if p.is_file())
        if len(self.img_files) != len(self.mask_files):
            raise ValueError(
                f"image/mask count mismatch: {len(self.img_files)} vs {len(self.mask_files)}"
            )

    def __len__(self) -> int:
        return len(self.img_files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img = _load_gray_u8(self.img_files[idx], self.size)
        mask = _load_gray_u8(self.mask_files[idx], self.size) > 0
        return {
            "image": img.astype(np.float32)[..., None] / 255.0,
            "mask": mask.astype(np.float32)[..., None],
        }


_DONE = object()


class _Failed:
    def __init__(self, error: Exception):
        self.error = error


_PREFETCH = 2  # batches decoded ahead of the one the device is on


class BatchLoader:
    """Shuffling batcher with one prefetch thread; yields {key: [B, ...] float32}.

    The partial last batch is kept, as torch's DataLoader keeps it in the
    reference (train.py:75-81). A batch that fails to load is logged and
    skipped, as the reference skips a failed batch; an epoch in which
    every batch failed raises.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def _batches(self) -> List[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        return [order[s : s + bs] for s in range(0, len(order), bs)]

    def _load(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        items = [self.dataset[int(i)] for i in idx]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batches()
        q: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for idx in batches:
                    try:
                        item = self._load(idx)
                    except Exception as e:  # a bad tile skips its batch, not the epoch
                        logger.error("batch load failed, skipping: %s", e)
                        item = _Failed(e)
                    if not put(item):
                        return
            finally:
                put(_DONE)

        thread = threading.Thread(target=produce, name="batch-loader", daemon=True)
        thread.start()
        produced, last_err = 0, None
        try:
            while (item := q.get()) is not _DONE:
                if isinstance(item, _Failed):
                    last_err = item.error
                    continue
                produced += 1
                yield item
            if batches and produced == 0 and last_err is not None:
                raise RuntimeError("every batch failed to load") from last_err
        finally:
            stop.set()
            thread.join()
