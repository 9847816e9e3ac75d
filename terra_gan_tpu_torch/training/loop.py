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

Preemption (JAX loop.py:45-150): SIGTERM, ``request_preemption()`` or the
drill ``TERRA_GAN_TPU_FAULT=preempt@E:B`` stops the run at the next batch
boundary, saves the latest state to ``preempted.pth`` beside the master
checkpoint (never over it) with the interrupted epoch and the best losses,
and raises ``TrainingPreempted``. A resumed run passes ``start_epoch`` and
``resume_best`` back and finishes the remaining epochs in the order the
uninterrupted run has; a completed run removes ``preempted.pth``. As in
the JAX package, a resume restarts the interrupted epoch from its first
batch. The asynchronous checkpoint writer, the QAT tail, the device mesh
and the experiment tracker of the JAX loop are not ported yet.
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import threading
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

_PREEMPT = threading.Event()

# the JAX package's drill variable, so that one drill runs on both packages
FAULT_ENV = "TERRA_GAN_TPU_FAULT"


def request_preemption() -> None:
    """Ask the running train() to checkpoint and stop at the next batch
    boundary. Safe from signal handlers and other threads."""
    _PREEMPT.set()


class TrainingPreempted(RuntimeError):
    """Training was interrupted (SIGTERM or the drill) and the latest state
    was saved to ``preempted.pth`` next to the master checkpoint, never
    over it, so the best-validation weights the master holds survive. The
    CLI maps it to exit code 75 (re-run the same command to resume)."""

    def __init__(self, state=None, epoch: Optional[int] = None,
                 checkpoint: Optional[Path] = None):
        super().__init__(f"training preempted at epoch {epoch}")
        self.state = state
        self.epoch = epoch
        self.checkpoint = checkpoint


@contextlib.contextmanager
def _preemption_guard():
    """SIGTERM -> graceful preemption for the epoch loop. Main thread only
    (signal.signal requires it); elsewhere request_preemption() still works."""
    armed, prev = False, None
    if threading.current_thread() is threading.main_thread():
        prev = signal.signal(signal.SIGTERM, lambda signum, frame: request_preemption())
        armed = True
        logger.info("preemption handler armed: SIGTERM checkpoints and stops "
                    "at the next batch boundary")
    try:
        yield
    finally:
        if armed:
            signal.signal(signal.SIGTERM, prev if prev is not None else signal.SIG_DFL)
        _PREEMPT.clear()


def _fault_injection(epoch: int, batch_idx: int) -> None:
    """``TERRA_GAN_TPU_FAULT=preempt@E:B`` requests a preemption at epoch E,
    batch B: the SIGTERM path without a signal, for tests and drills."""
    spec = os.environ.get(FAULT_ENV)
    if not spec:
        return
    try:
        kind, loc = spec.split("@", 1)
        at = tuple(int(v) for v in loc.split(":", 1))
    except ValueError:
        logger.warning("unrecognized %s spec: %r", FAULT_ENV, spec)
        return
    if kind == "preempt" and at == (epoch, batch_idx):
        logger.warning("fault injection: preempt@%d:%d", *at)
        request_preemption()


def _remove_preempted(path: Path) -> None:
    """Delete a consumed preempted checkpoint."""
    try:
        if path.exists():
            path.unlink()
            logger.info("consumed preempted checkpoint %s", path)
    except OSError as e:
        logger.warning("could not remove %s: %s", path, e)


def _to_device(batch: Dict[str, Any], dev: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays on ``dev``; other fields (a list of tile names) stay behind."""
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


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
    start_epoch: int = 0,
    resume_best: Optional[Dict[str, float]] = None,
    preempt_extra: Optional[Dict[str, Any]] = None,
    record_config: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Adversarial training over one split; updates ``state`` in place.

    Both Adams train at ``config.learning_rate``: it is set on every
    parameter group of ``state.g_opt`` and ``state.d_opt`` before the first
    step. Each checkpoint records ``record_config`` as its ``config`` (the
    CLI passes the whole YAML config, as the JAX CLI does), else
    ``asdict(config)``.

    ``start_epoch`` / ``resume_best``: preemption resume. The run finishes
    epochs [start_epoch, epochs) with the shuffle stream fast-forwarded to
    ``start_epoch``, and compares against the best losses carried in
    ``resume_best`` (``best_val_loss``, ``best_train_loss``) instead of
    inf. ``preempt_extra`` rides in ``preempted.pth`` (the CLI stamps the
    parent grid there).

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
        config.batch_size, shuffle=True, seed=seed, num_workers=config.feed_workers,
    )
    val_loader = None
    if val_img_dir and val_mask_dir:
        val_ds = InpaintingDataset(val_img_dir, val_mask_dir, size=image_size)
        if len(val_ds):
            val_loader = BatchLoader(val_ds, config.batch_size, shuffle=False,
                                     num_workers=config.feed_workers)
    step_fn = make_train_step(loss_cfg)
    eval_fn = make_eval_step(loss_cfg)
    checkpoint_path = Path(checkpoint_path) if checkpoint_path else None
    saved_config = asdict(config) if record_config is None else record_config

    best_val = best_train = float("inf")
    if resume_best:
        best_val = float(resume_best.get("best_val_loss", best_val))
        best_train = float(resume_best.get("best_train_loss", best_train))
    start_epoch = max(0, min(int(start_epoch), config.epochs))
    if start_epoch:
        loader.set_epoch(start_epoch)
        logger.info("resuming training at epoch %d/%d (best_val=%s)", start_epoch,
                    config.epochs, best_val)
    history = []
    t_start = time.time()
    epoch = -1
    with _preemption_guard():
        for epoch in range(start_epoch, config.epochs):
            t_epoch = time.time()
            sums: Dict[str, torch.Tensor] = {}
            n_batches, last_err = 0, None
            for batch_idx, batch in enumerate(loader):
                _fault_injection(epoch, batch_idx)
                if _PREEMPT.is_set():
                    # outside the per-batch except: a preemption is never skipped
                    preempted = None
                    if checkpoint_path is not None:
                        preempted = checkpoint_path.parent / "preempted.pth"
                        logger.warning("preemption requested: saving latest state to %s "
                                       "(epoch %d, batch %d)", preempted, epoch, batch_idx)
                        export_pth(preempted, state, epoch, saved_config, {
                            "preempted": True, "best_val_loss": best_val,
                            "best_train_loss": best_train, **(preempt_extra or {})})
                    raise TrainingPreempted(state=state, epoch=epoch, checkpoint=preempted)
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
                export_pth(checkpoint_path, state, epoch, saved_config, extra)

            # periodic checkpoint every checkpoint_interval epochs (train.py:400-405)
            if checkpoint_path is not None and epoch % config.checkpoint_interval == 0:
                export_pth(checkpoint_path.parent / f"checkpoint_epoch_{epoch}.pth",
                           state, epoch, saved_config)

            history.append(row)
            logger.info("epoch %d: %s", epoch, {k: round(v, 6) for k, v in row.items()})

    if checkpoint_path is not None:
        # a completed run supersedes any preempted.pth it resumed from
        _remove_preempted(checkpoint_path.parent / "preempted.pth")
    return {
        "best_train_loss": best_train,
        "best_val_loss": best_val if val_loader is not None else None,
        "total_time": time.time() - t_start,
        "final_epoch": epoch,
        "state": state,
        "history": history,
    }
