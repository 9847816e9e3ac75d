"""The training loop (counterpart of terra_gan_tpu/training/loop.py :: train).

The reference's control flow (mvp_gan/src/train.py:23-453): epochs over
a shuffled loader, one train step per batch, per-epoch validation,
best-checkpoint selection on the validation g-loss (the train g-loss
when there is no validation set), and a periodic checkpoint. A batch
whose step fails is logged and skipped (train.py:268-270); an epoch in
which every batch failed raises, since that is systematic, not a bad
tile. Batch losses stay on the device and are read once per epoch and
every ``log_interval`` batches.

It runs where the state's modules are: on a card the train steps run K1
forward and backward, and validation the eval forward's K2, K1 and K3.
Preemption and resume, the asynchronous checkpoint writer, the QAT tail,
the device mesh and the experiment tracker of the JAX loop are not
ported yet.
"""

from __future__ import annotations

import logging
import time
from dataclasses import asdict
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import LoopConfig
from ..data.dataset import BatchLoader, InpaintingDataset
from ..models.vgg import VGG16Features
from .checkpoint import export_pth
from .state import GANTrainState
from .step import make_eval_step, make_train_step

logger = logging.getLogger(__name__)

_EPOCH_LOSSES = ("g_loss", "d_loss", "real_loss", "fake_loss")


def _to_device(batch: Dict[str, np.ndarray], dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def train(
    img_dir: str | Path,
    mask_dir: str | Path,
    state: GANTrainState,
    config: Optional[LoopConfig] = None,
    checkpoint_path: Optional[str | Path] = None,
    val_img_dir: Optional[str | Path] = None,
    val_mask_dir: Optional[str | Path] = None,
    vgg: Optional[VGG16Features] = None,
    image_size: int = 512,
    seed: int = 0,
) -> Dict[str, Any]:
    """Adversarial training over one split; updates ``state`` in place.

    Both Adams train at ``config.learning_rate``: it is set on every
    parameter group of ``state.g_opt`` and ``state.d_opt`` before the first
    step, so the config each checkpoint records is the one the run used.

    Returns {'best_train_loss', 'best_val_loss', 'total_time',
    'final_epoch', 'state'} (the reference's contract and the state) and
    'history', one dict of epoch means and times per epoch.
    """
    config = config or LoopConfig()
    loss_cfg = config.loss_config()
    dev = state.device
    for opt in (state.g_opt, state.d_opt):
        for group in opt.param_groups:
            group["lr"] = config.learning_rate
    loader = BatchLoader(
        InpaintingDataset(img_dir, mask_dir, size=image_size),
        config.batch_size, shuffle=True, seed=seed,
    )
    val_loader = None
    if val_img_dir and val_mask_dir:
        val_ds = InpaintingDataset(val_img_dir, val_mask_dir, size=image_size)
        if len(val_ds):
            val_loader = BatchLoader(val_ds, config.batch_size, shuffle=False)
    step_fn = make_train_step(loss_cfg)
    eval_fn = make_eval_step(loss_cfg)
    checkpoint_path = Path(checkpoint_path) if checkpoint_path else None

    best_val = best_train = float("inf")
    history = []
    t_start = time.time()
    epoch = -1
    for epoch in range(config.epochs):
        t_epoch = time.time()
        sums: Dict[str, torch.Tensor] = {}
        n_batches, last_err = 0, None
        for batch_idx, batch in enumerate(loader):
            try:
                metrics = step_fn(state, _to_device(batch, dev), vgg)
            except Exception as e:  # the reference's per-batch skip
                logger.error("batch %d failed, skipping: %s", batch_idx, e)
                last_err = e
                continue
            n_batches += 1
            for k in _EPOCH_LOSSES:
                sums[k] = sums[k] + metrics[k] if k in sums else metrics[k]
            if batch_idx % config.log_interval == 0:
                logger.info("epoch %d batch %d: %s", epoch, batch_idx,
                            {k: round(float(v), 6) for k, v in metrics.items()})
        if n_batches == 0:
            if last_err is not None:
                raise RuntimeError(
                    f"training made no progress: every batch of epoch {epoch} failed"
                ) from last_err
            logger.warning("no batches in epoch %d", epoch)
            continue
        row: Dict[str, Any] = {k: float(v) / n_batches for k, v in sums.items()}
        row.update(epoch=epoch, steps=n_batches, epoch_time=time.time() - t_epoch)

        # validation (train.py:277-303)
        val_g = val_d = None
        if val_loader is not None:
            vg = vd = 0.0
            nv = 0
            for vb in val_loader:
                _, vm = eval_fn(state, _to_device(vb, dev), vgg)
                vg += float(vm["val_g_loss"])
                vd += float(vm["val_d_loss"])
                nv += 1
            if nv:
                val_g, val_d = vg / nv, vd / nv
                row.update(val_g_loss=val_g, val_d_loss=val_d)

        # best-model checkpoint (train.py:314-397)
        improved = False
        if val_g is not None:
            if val_g < best_val:
                best_val, improved = val_g, True
        elif row["g_loss"] < best_train:
            best_train, improved = row["g_loss"], True
        if val_g is None:
            best_train = min(best_train, row["g_loss"])
        if improved and checkpoint_path is not None:
            extra = {"epoch": epoch, "g_loss": row["g_loss"], "d_loss": row["d_loss"]}
            if val_g is not None:
                extra.update(val_g_loss=val_g, val_d_loss=val_d)
            export_pth(checkpoint_path, state, epoch, asdict(config), extra)

        # periodic checkpoint every checkpoint_interval epochs (train.py:400-405)
        if checkpoint_path is not None and epoch % config.checkpoint_interval == 0:
            export_pth(checkpoint_path.parent / f"checkpoint_epoch_{epoch}.pth",
                       state, epoch, asdict(config))

        history.append(row)
        logger.info("epoch %d: %s", epoch, {k: round(v, 6) for k, v in row.items()})

    return {
        "best_train_loss": best_train,
        "best_val_loss": best_val if val_loader is not None else None,
        "total_time": time.time() - t_start,
        "final_epoch": epoch,
        "state": state,
        "history": history,
    }
