"""Human-guided fine-tuning (counterpart of terra_gan_tpu/training/human_guided.py;
reference: mvp_gan/src/training/human_guided_trainer.py:44-262).

A generator-only fine-tune (no discriminator) of any of the generators
(PConvUNet, FFCResNetGenerator, DeepFillV2Generator: the loss on the
final composite) on matched human annotations: the
train-mode forward on ``real * mask``, HumanGuidedLoss (the perceptual
term on a frozen VGG's features[:16]), and Adam at
``training.modes.human_guided.learning_rate``. The loader keeps the
partial last batch (the reference's DataLoader default). NaN or Inf
batch losses are left out of the epoch average (the reference's guard at
human_guided_trainer.py:146-148), and the average is 0.0 unless the sum
of the finite losses is above 0. Every epoch writes
``generator_epoch_{e}.pth``, and ``best_model.pth`` when
``0 < average < best``.

On a card each step's generator forward packs K2's weight planes once,
runs its 14 PConv stages on K2's train variant and launches K1 forward 7
times; its backward launches K1 backward 7 times, and its convolutions'
dgrad and wgrad are cuDNN's. Under a profiler a step is the range ``tg.hg_step``, holding in
order ``tg.g_forward``, ``tg.loss`` (``human_guided_loss`` with VGG),
``tg.g_backward`` and ``tg.g_adam`` (utils/trace.py).

Preemption is the initial-training loop's (SIGTERM, ``request_preemption``
or ``TERRA_GAN_TPU_FAULT=preempt@E:B``): at the next batch boundary the
generator goes to ``preempted.pth`` in the checkpoint directory and
``TrainingPreempted`` is raised; a completed run removes the file. As in
the JAX package, a run resumed from it starts again at epoch 0.
"""

from __future__ import annotations

import logging
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..config import Config
from ..data.dataset import BatchLoader
from ..losses import HumanGuidedLossConfig, InpaintingLossConfig, human_guided_loss
from ..models.vgg import VGG16Features
from ..utils.trace import span
from .checkpoint import save_pth
from .loop import (
    _PREEMPT,
    TrainingPreempted,
    _fault_injection,
    _preemption_guard,
    _remove_preempted,
    _to_device,
)
from .state import adam

logger = logging.getLogger(__name__)

def hg_loss_config(config: Config) -> HumanGuidedLossConfig:
    """HumanGuidedLoss reads the YAML's boundary weight (losses.py:139),
    unlike initial training: the reference's ``loss_weights.get('boundary',
    0.5)``, so an explicit 0 means 0 and a missing key or null means 0.5."""
    lw = config.training.loss_weights
    raw_lw = (config.raw.get("training") or {}).get("loss_weights") or {}
    boundary = raw_lw.get("boundary", 0.5)
    if boundary is None:
        boundary = 0.5
    hg = config.training.human_guided
    return HumanGuidedLossConfig(
        base=InpaintingLossConfig(perceptual_weight=lw.perceptual, tv_weight=lw.tv,
                                  boundary_weight=float(boundary)),
        base_loss_weight=hg.base_loss_weight,
        human_feedback_weight=hg.human_feedback_weight,
    )


class HumanGuidedTrainer:
    def __init__(self, config: Config):
        self.config = config
        self.loss_config = hg_loss_config(config)

    def make_step(
        self, generator: torch.nn.Module, opt: torch.optim.Optimizer
    ) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
        """step(batch, vgg) -> (loss, components): one forward, backward and
        Adam update of ``generator`` in place; batch = {'image', 'mask',
        'human_mask'} NHWC [B,H,W,1] on the generator's device."""
        loss_cfg = self.loss_config

        def step(batch, vgg):
            with span("tg.hg_step"):
                generator.train()
                opt.zero_grad(set_to_none=True)
                real, mask = batch["image"], batch["mask"]
                with span("tg.g_forward"):
                    gen = generator(real * mask, mask)
                with span("tg.loss"):
                    total, comps = human_guided_loss(gen, real, mask, batch.get("human_mask"),
                                                     vgg, loss_cfg)
                with span("tg.g_backward"):
                    total.backward()
                with span("tg.g_adam"):
                    opt.step()
                return total.detach(), {k: v.detach() for k, v in comps.items()}

        return step

    def _checkpoint(self, generator: torch.nn.Module, epoch: int, **extra) -> Dict[str, Any]:
        return {"epoch": epoch, "model_state_dict": generator.state_dict(), **extra,
                "config": self.config.raw}

    def train(
        self,
        generator: torch.nn.Module,
        dataset,
        num_epochs: Optional[int] = None,
        checkpoint_dir: str | Path = "checkpoints_hg",
        vgg: Optional[VGG16Features] = None,
    ) -> Dict[str, Any]:
        """Fine-tune ``generator`` in place on ``dataset`` (DirectMatchDataset
        items). Returns {'best_loss' (None if no epoch improved), 'total_time',
        'epoch_losses', 'generator'}."""
        hg = self.config.training.human_guided
        num_epochs = num_epochs or hg.epochs
        checkpoint_dir = Path(checkpoint_dir)
        checkpoint_dir.mkdir(parents=True, exist_ok=True)
        dev = next(generator.parameters()).device
        step_fn = self.make_step(generator, adam(generator.parameters(), hg.learning_rate))
        loader = BatchLoader(dataset, batch_size=hg.batch_size, shuffle=True,
                             drop_last=False, num_workers=self.config.training.feed_workers)
        best_loss = float("inf")
        history = []
        t0 = time.time()
        with _preemption_guard():
            for epoch in range(num_epochs):
                t_epoch = time.time()
                epoch_loss, success, batches = 0.0, 0, 0
                for batch_idx, batch in enumerate(loader):
                    _fault_injection(epoch, batch_idx)
                    if _PREEMPT.is_set():
                        preempted = checkpoint_dir / "preempted.pth"
                        logger.warning("HG preemption requested: checkpointing at epoch %d, "
                                       "batch %d", epoch, batch_idx)
                        save_pth(preempted, self._checkpoint(generator, epoch, preempted=True))
                        raise TrainingPreempted(epoch=epoch, checkpoint=preempted)
                    loss, _ = step_fn(_to_device(batch, dev), vgg)
                    batches += 1
                    lv = float(loss)
                    if math.isfinite(lv):
                        epoch_loss += lv
                        success += 1

                avg = epoch_loss / max(1, success) if epoch_loss > 0 else 0.0
                epoch_time = time.time() - t_epoch
                history.append(avg)
                ckpt = self._checkpoint(generator, epoch, loss=avg)
                try:
                    save_pth(checkpoint_dir / f"generator_epoch_{epoch}.pth", ckpt)
                    if 0.0 < avg < best_loss:
                        best_loss = avg
                        save_pth(checkpoint_dir / "best_model.pth", ckpt)
                        logger.info("new best HG model: loss=%.6f", best_loss)
                except Exception as e:
                    logger.error("HG checkpoint save failed: %s", e)
                logger.info("HG epoch %d: loss=%.6f time=%.2fs success=%d/%d", epoch, avg,
                            epoch_time, success, batches)

        # a completed fine-tune supersedes any preempted.pth it resumed from
        _remove_preempted(checkpoint_dir / "preempted.pth")
        return {
            "best_loss": best_loss if math.isfinite(best_loss) else None,
            "total_time": time.time() - t0,
            "epoch_losses": history,
            "generator": generator,
        }
