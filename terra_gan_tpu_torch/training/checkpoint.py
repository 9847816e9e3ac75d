"""Reference-layout ``.pth`` checkpoints (counterpart of terra_gan_tpu/training/checkpoint.py).

A master checkpoint is the dict the reference writes (train.py:318-330,
main_pipeline.py:386-397): ``epoch``, ``generator_state_dict``,
``discriminator_state_dict``, ``optimizer_G_state_dict``,
``optimizer_D_state_dict`` and ``config``, plus extras such as the
losses, and ``architecture``, the generator's ("pconv_unet",
"big_lama" or "deepfill_v2", ``utils.weights.generator_architecture``). The Adam states
are torch's own, numbered by ``.parameters()`` order: 72 entries for the
generator (its 14 frozen mask convs have none of their own state) and 16
for the discriminator, as the reference's and the JAX package's
``export_pth`` / ``import_pth``, so a checkpoint written by any of the
three resumes in the others. The JAX package's orbax format is not
ported.

Load priority chain (main_pipeline.py:227-245, ``resolve_checkpoint``):
a ``preempted.pth`` left by an interrupted run, then an explicit
``--input_model``, then the master checkpoint, then
``_BASELINE_MODEL/BASELINE_MODEL.pth``, then a fresh init. A raw
generator state dict (the legacy format) loads as the generator alone.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from ..utils.weights import generator_architecture
from .state import GANTrainState

logger = logging.getLogger(__name__)


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_pth(path: str | Path, obj: Dict[str, Any]) -> None:
    """torch.save of ``obj`` with every tensor on the CPU; atomic (a
    temporary file, then a rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(_to_cpu(obj), tmp)
    os.replace(tmp, path)


def export_pth(
    path: str | Path,
    state: GANTrainState,
    epoch: int = 0,
    config: Optional[Dict] = None,
    extra: Optional[Dict] = None,
) -> None:
    """Write a reference-layout master checkpoint; atomic (temporary file, then rename)."""
    generator = state.generator.state_dict()
    ckpt: Dict[str, Any] = {
        "epoch": epoch,
        "architecture": generator_architecture(generator),
        "generator_state_dict": generator,
        "discriminator_state_dict": state.discriminator.state_dict(),
        "optimizer_G_state_dict": state.g_opt.state_dict(),
        "optimizer_D_state_dict": state.d_opt.state_dict(),
        "config": config or {},
    }
    if extra:
        ckpt.update(extra)
    save_pth(path, ckpt)


def import_pth(path: str | Path, state: GANTrainState) -> Tuple[GANTrainState, Dict]:
    """Load a master checkpoint into ``state`` in place, strictly.

    Both networks load with ``strict=True`` and both Adam states load
    when present. The reference layout carries no step count; the
    generator's Adam step is the number of optimizer steps taken, so
    ``state.step`` continues from it. Returns (state, the non-state-dict
    entries: epoch, config, losses, ...). A raw generator state dict
    (the legacy format) loads into the generator alone and returns {}.
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(obj, dict) and "generator_state_dict" in obj):
        state.generator.load_state_dict(obj, strict=True)
        return state, {}
    state.generator.load_state_dict(obj["generator_state_dict"], strict=True)
    if "discriminator_state_dict" in obj:
        state.discriminator.load_state_dict(obj["discriminator_state_dict"], strict=True)
    if "optimizer_G_state_dict" in obj:
        state.g_opt.load_state_dict(obj["optimizer_G_state_dict"])
    if "optimizer_D_state_dict" in obj:
        state.d_opt.load_state_dict(obj["optimizer_D_state_dict"])
    steps = [int(s["step"]) for s in state.g_opt.state_dict()["state"].values()]
    state.step = max(steps, default=0)
    return state, {k: v for k, v in obj.items() if not k.endswith("_state_dict")}


def resolve_checkpoint(
    input_model: Optional[str | Path],
    master_checkpoint: Optional[str | Path],
    baseline_model: Optional[str | Path] = "_BASELINE_MODEL/BASELINE_MODEL.pth",
    preempted: Optional[str | Path] = None,
) -> Optional[Path]:
    """The checkpoint to start from (JAX ``resolve_checkpoint``).

    A ``preempted`` file outranks every other leg: it exists only if the
    previous run was interrupted (``training.loop.train`` writes it on a
    preemption and removes it when a run completes), so re-running the
    same command continues from the interrupted state even where that
    command names an ``--input_model``. Then ``input_model``, the master
    checkpoint and the baseline model, the first that exists; None for a
    fresh init.
    """
    if preempted and Path(preempted).exists():
        logger.warning(
            "resuming from preempted checkpoint %s (latest interrupted "
            "state; outranks input_model/master until consumed by a "
            "completed run)", preempted,
        )
        return Path(preempted)
    for candidate in (input_model, master_checkpoint, baseline_model):
        if candidate and Path(candidate).exists():
            logger.info("using checkpoint: %s", candidate)
            return Path(candidate)
    logger.info("no checkpoint found; fresh initialization")
    return None
