"""The pipeline CLI (counterpart of terra_gan_tpu/cli/main_pipeline.py).

    python -m terra_gan_tpu_torch.cli.main_pipeline --mode evaluate
        [--input_model PATH] [--grid GRID] [--config PATH] [--debug]
        [--device cuda|cpu]
    python -m terra_gan_tpu_torch --mode evaluate ...

The JAX CLI's flags and contracts for the mode the port runs:
  * evaluate (main_pipeline.py:446-556): load the master generator
    (``--input_model`` or ``<evaluation.checkpoint_dir>/master_checkpoint.pth``),
    inpaint every test tile of ``--grid`` or of every valid parent grid
    under ``data.processed_dir`` (``inpaint_directory``, whole splits in
    chunks), then colorize them; exit 0 if any tile was written, else 1;
  * env switches: EXPERIMENT_MODE (no interactive prompts,
    main_pipeline.py:602), DOCKER_ENV rebases the data paths under /app
    (main_pipeline.py:33-38);
  * logging to the console and logs/pipeline.log (main_pipeline.py:59-71).

It runs on the card unless ``--device cpu`` is given; without CUDA the
default device raises. Not ported yet, and refused with exit code 2:
``--mode train`` and ``--mode human_guided_train``, ``--mesh``, and a
config that sets ``evaluation.quant``. Experiment tracking is not ported:
with ``experiment_tracking.enabled`` the run logs a warning and goes on
untracked.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path
from typing import Optional

logger = logging.getLogger("terra_gan_tpu_torch.pipeline")

NOT_PORTED_EXIT = 2


def setup_logging(debug: bool = False) -> None:
    Path("logs").mkdir(exist_ok=True)
    logging.basicConfig(
        level=logging.DEBUG if debug else logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
        handlers=[
            logging.StreamHandler(),
            logging.FileHandler("logs/pipeline.log"),
        ],
        force=True,
    )


def experiment_mode() -> bool:
    return os.environ.get("EXPERIMENT_MODE", "").lower() in ("1", "true", "yes")


def _load_config(config_path: str):
    from ..config import Config

    if Path(config_path).exists():
        cfg = Config.load(config_path)
    else:
        logger.warning("config %s not found; using defaults", config_path)
        cfg = Config()
    if os.environ.get("DOCKER_ENV"):
        base = Path("/app")
        for field in ("raw_dir", "processed_dir", "output_dir",
                      "input_zip_folder", "models_dir"):
            setattr(cfg.data, field, str(base / getattr(cfg.data, field)))
    return cfg


def _master_checkpoint_path(cfg) -> Path:
    return Path(cfg.evaluation.checkpoint_dir) / "master_checkpoint.pth"


def _image_size(cfg) -> int:
    """Model tile size; 512 in the reference (train.py:67-70). The
    data.image_size config key exists for small-scale tests/dev runs."""
    return int((cfg.raw.get("data") or {}).get("image_size", 512))


def run_evaluation_mode(
    cfg, input_model: Optional[str] = None, target_grid: Optional[str] = None,
    device="cuda",
) -> bool:
    from ..data.paths import PathManager, is_valid_parent_grid
    from ..data.visualization import DSMColorizer
    from ..evaluation.inference import inpaint_directory
    from ..utils.weights import load_generator

    pm = PathManager(cfg)
    processed = Path(cfg.data.processed_dir)
    model_path = Path(input_model) if input_model else _master_checkpoint_path(cfg)
    if not model_path.exists():
        logger.error("no model for evaluation: %s", model_path)
        return False

    if target_grid and is_valid_parent_grid(target_grid):
        if not (processed / target_grid).is_dir():
            logger.error("grid %s not in processed data", target_grid)
            return False
        parents = [target_grid]
    else:
        parents = sorted(
            d.name for d in processed.glob("[A-Z][A-Z]*")
            if d.is_dir() and is_valid_parent_grid(d.name)
        )
    if not parents:
        logger.error("no processed parent grids found")
        return False

    G = load_generator(model_path, device)
    total = 0
    for parent in parents:
        paths = pm.create_parent_structure(parent)
        test_images = processed / parent / "test" / "images"
        test_masks = processed / parent / "test" / "masks"
        if not (test_images.exists() and test_masks.exists()):
            logger.warning("no test split for %s; skipping", parent)
            continue
        outs = inpaint_directory(
            G, test_images, test_masks, paths["output_inpainted"],
            device=device, model_size=_image_size(cfg),
        )
        if outs:
            DSMColorizer(
                paths["output_inpainted"], paths["output_colored"]
            ).recolor_all()
        logger.info("%s: %d tiles inpainted + colorized", parent, len(outs))
        total += len(outs)
    return total > 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="TERRA-GAN pipeline (PyTorch, CUDA)"
    )
    parser.add_argument(
        "--mode", required=True,
        choices=["train", "evaluate", "human_guided_train"],
        help="evaluate; train and human_guided_train are not ported yet",
    )
    parser.add_argument("--input_model", default=None)
    parser.add_argument("--grid", default=None)
    parser.add_argument("--config", default="config.yaml")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument(
        "--no-tracking", action="store_true",
        help="disable experiment tracking for this run",
    )
    parser.add_argument("--mesh", default=None, metavar="DATAxSPATIAL",
                        help="not ported yet")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    setup_logging(args.debug)
    if args.mode != "evaluate":
        logger.error("--mode %s is not ported yet: the PyTorch port runs --mode evaluate",
                     args.mode)
        return NOT_PORTED_EXIT
    if args.mesh:
        logger.error("--mesh is not ported yet: the PyTorch port runs on one device")
        return NOT_PORTED_EXIT
    cfg = _load_config(args.config)
    if cfg.evaluation.quant is not None:
        logger.error("evaluation.quant (%s) is not ported yet: the PyTorch port "
                     "evaluates in fp32", cfg.evaluation.quant)
        return NOT_PORTED_EXIT
    if not args.no_tracking and cfg.experiment_tracking.enabled:
        logger.warning("experiment tracking is not ported yet: this run is not tracked")

    from ..utils.device import resolve_device

    device = resolve_device(args.device)  # no CUDA for the default device raises here
    ok = run_evaluation_mode(cfg, args.input_model, args.grid, device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
