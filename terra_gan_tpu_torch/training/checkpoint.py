"""Reference-layout ``.pth`` checkpoints (counterpart of terra_gan_tpu/training/checkpoint.py).

A master checkpoint is the dict the reference writes (train.py:318-330,
main_pipeline.py:386-397): ``epoch``, ``generator_state_dict``,
``discriminator_state_dict``, ``optimizer_G_state_dict``,
``optimizer_D_state_dict`` and ``config``, plus extras such as the
losses. The Adam states are torch's own, numbered by ``.parameters()``
order: 72 entries for the generator (its 14 frozen mask convs have none
of their own state) and 16 for the discriminator, as the reference's and
the JAX package's ``export_pth`` / ``import_pth``, so a checkpoint
written by any of the three resumes in the others. The JAX package's
orbax format is not ported.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from .state import GANTrainState


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def export_pth(
    path: str | Path,
    state: GANTrainState,
    epoch: int = 0,
    config: Optional[Dict] = None,
    extra: Optional[Dict] = None,
) -> None:
    """Write a reference-layout master checkpoint; atomic (temporary file, then rename)."""
    ckpt: Dict[str, Any] = {
        "epoch": epoch,
        "generator_state_dict": state.generator.state_dict(),
        "discriminator_state_dict": state.discriminator.state_dict(),
        "optimizer_G_state_dict": state.g_opt.state_dict(),
        "optimizer_D_state_dict": state.d_opt.state_dict(),
        "config": config or {},
    }
    if extra:
        ckpt.update(extra)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(_to_cpu(ckpt), tmp)
    os.replace(tmp, path)


def import_pth(path: str | Path, state: GANTrainState) -> Tuple[GANTrainState, Dict]:
    """Load a master checkpoint into ``state`` in place, strictly.

    Both networks load with ``strict=True`` and both Adam states load
    when present. The reference layout carries no step count; the
    generator's Adam step is the number of optimizer steps taken, so
    ``state.step`` continues from it. Returns (state, the non-state-dict
    entries: epoch, config, losses, ...).
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(obj, dict) and "generator_state_dict" in obj):
        raise ValueError(f"{path}: not a master checkpoint (no generator_state_dict)")
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
