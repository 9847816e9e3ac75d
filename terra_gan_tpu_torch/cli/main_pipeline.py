"""The pipeline CLI (counterpart of terra_gan_tpu/cli/main_pipeline.py).

    python -m terra_gan_tpu_torch.cli.main_pipeline
        --mode {train,evaluate,human_guided_train}
        [--input_model PATH] [--grid GRID] [--config PATH] [--debug]
        [--device cuda|cpu]
    python -m terra_gan_tpu_torch --mode evaluate ...

The JAX CLI's flags and contracts for the modes the port runs:
  * train (main_pipeline.py:185-361): every zip in data.input_zip_folder
    (sorted) is ingested (``ingest_zip``: DSM PNGs and detector masks),
    its tiles split on the checkerboard, and ONE master
    generator+discriminator trained across the parent grids in turn.
    The generator is the config's ``model.generator``: the PConv U-Net
    (the default), Big-LaMa's FFC ResNet or DeepFill v2 at its published
    sizes. The
    state starts from the first of preempted.pth, ``--input_model``,
    the master checkpoint, _BASELINE_MODEL/BASELINE_MODEL.pth
    (``resolve_checkpoint``), else a fresh seeded init; a preempted.pth
    fast-forwards its own parent's schedule. At the end the master
    checkpoint (config = the YAML config), a timestamped copy and
    training_metrics_<ts>.json; exit 0 if any grid trained, 1 if none,
    75 when preempted (re-run the same command to resume). The
    perceptual VGG runs on training.vgg_weights_path, else on the port's
    seeded init, tagged ``random:torch-seed0`` (it is not the JAX
    package's ``random:seed0``, which jax.random draws);
  * evaluate (main_pipeline.py:446-556): load the master generator
    (``--input_model`` or ``<evaluation.checkpoint_dir>/master_checkpoint.pth``,
    either architecture, by its keys),
    inpaint every test tile of ``--grid`` or of every valid parent grid
    under ``data.processed_dir`` (``inpaint_directory``, whole splits in
    chunks), then colorize them; exit 0 if any tile was written, else 1;
  * human_guided_train (main_pipeline.py:476-598): fine-tune the
    generator alone on human annotations. It starts from
    ``<checkpoint_dir>/human_guided/preempted.pth`` where an interrupted
    run left one, else from ``--input_model`` or the master checkpoint
    (``source_model`` records that lineage either way). The grid is
    ``--grid``, else under EXPERIMENT_MODE the first zip's name, else
    asked for. With ``portal.base_url`` set the grid's annotations are
    fetched from the portal (a failure falls back to the local files);
    they are matched with the test split's system masks and images
    (``match_human_and_system_masks``), and a ``DirectMatchDataset``
    whose human masks are not all empty is fine-tuned
    (``HumanGuidedTrainer``). The generator-only master goes to both
    ``master_model_human_guided_<ts>.pth`` and the master checkpoint;
    under EXPERIMENT_MODE the portal's matched annotations are then
    deleted. Exit 0, 1 when no model, no pair or no non-empty human mask
    is found, 75 when preempted (re-run to resume; the run starts again
    at epoch 0, as in the JAX package);
  * env switches: EXPERIMENT_MODE (no interactive prompts,
    main_pipeline.py:602), DOCKER_ENV rebases the data paths under /app
    (main_pipeline.py:33-38);
  * logging to the console and logs/pipeline.log (main_pipeline.py:59-71).

It runs on the card unless ``--device cpu`` is given; without CUDA the
default device raises. Not ported yet, and refused with exit code 2:
``--mesh``, and a config that sets
``evaluation.quant``, a QAT tail (``training.qat_tail.steps``) or a bf16
``training.compute_dtype`` (``bf16`` or ``bfloat16``; ``float32`` or no
key is the fp32 the port runs). Experiment tracking is not ported: with
``experiment_tracking.enabled`` the run logs a warning and goes on
untracked; ``training.async_checkpoint`` writes synchronously.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger("terra_gan_tpu_torch.pipeline")

NOT_PORTED_EXIT = 2
PREEMPTED_EXIT = 75  # EX_TEMPFAIL: re-run the same command to resume
BASELINE_MODEL = "_BASELINE_MODEL/BASELINE_MODEL.pth"
# the port's seeded VGG, not the JAX package's random_weights(0)
VGG_RANDOM_TAG = "random:torch-seed0"


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


def _bf16_requested(cfg) -> bool:
    """training.compute_dtype asks for the bf16 perf mode, as the JAX CLI
    reads it (main_pipeline.py:103-108); anything else is fp32."""
    name = (cfg.raw.get("training") or {}).get("compute_dtype")
    return str(name).lower() in ("bf16", "bfloat16")


def _load_vgg(cfg, device):
    """Perceptual-loss weights and their provenance: training.vgg_weights_path
    ("pretrained:<path>"), else the port's seeded init (VGG_RANDOM_TAG)
    where the perceptual weight is positive, else (None, "none")."""
    import torch

    from ..utils.weights import init_vgg, load_vgg

    path = (cfg.raw.get("training") or {}).get("vgg_weights_path")
    if path and Path(path).exists():
        return load_vgg(path, device), f"pretrained:{path}"
    if cfg.training.loss_weights.perceptual > 0:
        logger.warning(
            "no pretrained VGG weights configured (training.vgg_weights_path); "
            "using the port's seeded random VGG features for the perceptual term"
        )
        return init_vgg(torch.Generator().manual_seed(0), device), VGG_RANDOM_TAG
    return None, "none"


def _init_master_state(cfg, input_model: Optional[str], device):
    """The master state (full width, the config's ``model.generator``) and,
    for a preempted.pth, its resume record: the first checkpoint of the
    load chain, else a fresh init (torch's default conv init from seed 0,
    fresh BatchNorm)."""
    import torch

    from ..training.checkpoint import import_pth, resolve_checkpoint
    from ..training.state import GANTrainState
    from ..utils.weights import init_discriminator, init_generator

    gen = torch.Generator().manual_seed(0)
    G = init_generator(64, gen, device, arch=cfg.model.generator)
    for mod in G.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.reset_parameters()
    state = GANTrainState.create(G, init_discriminator(64, gen, device),
                                 lr=cfg.training.initial.learning_rate)
    master = _master_checkpoint_path(cfg)
    ckpt = resolve_checkpoint(input_model, master, BASELINE_MODEL,
                              preempted=master.parent / "preempted.pth")
    resume = None
    if ckpt is not None:
        try:
            state, extra = import_pth(ckpt, state)
            logger.info("loaded checkpoint %s (epoch %s)", ckpt, extra.get("epoch"))
            if extra.get("preempted"):
                # the interrupted epoch, the best losses and the parent grid:
                # run_training_mode fast-forwards that parent's train()
                resume = extra
        except Exception as e:
            logger.error("checkpoint load failed (%s); fresh init", e)
    return state, resume


def run_training_mode(cfg, input_model: Optional[str] = None, device="cuda") -> bool:
    from ..config import LoopConfig
    from ..data.ingest import ingest_zip
    from ..data.paths import PathManager
    from ..data.splitting import GeographicalSplitter
    from ..data.visualization import create_split_visualization
    from ..training.checkpoint import export_pth
    from ..training.loop import TrainingPreempted, train

    zip_folder = Path(cfg.data.input_zip_folder)
    zips = sorted(zip_folder.glob("*.zip")) if zip_folder.exists() else []
    if not zips:
        logger.error("no input zips in %s", zip_folder)
        return False

    pm = PathManager(cfg)
    state, resume = _init_master_state(cfg, input_model, device)
    loop_cfg = LoopConfig.from_training(cfg.training)
    vgg, vgg_provenance = _load_vgg(cfg, device)
    successful: List[str] = []
    failed: List[str] = []
    metrics: Dict[str, Any] = {}

    for zip_path in zips:
        try:
            parent = pm.parent_from_zip(zip_path)
        except ValueError as e:
            logger.error("%s", e)
            failed.append(zip_path.name)
            continue
        logger.info("=== processing parent grid %s ===", parent)
        try:
            splitter = GeographicalSplitter(parent, Path(cfg.data.processed_dir))
            if not ingest_zip(zip_path, parent, cfg, splitter=splitter, device=device):
                failed.append(parent)
                continue
            splitter.generate_splits()
            splitter.apply_splits()
            splitter.save_metadata()
            try:
                create_split_visualization(
                    Path(cfg.data.processed_dir) / parent / "metadata", parent_grid=parent
                )
            except Exception as e:
                logger.warning("split visualization failed: %s", e)

            proc = Path(cfg.data.processed_dir) / parent
            resume_kwargs = {}
            if resume is not None and resume.get("parent") in (None, parent):
                # fast-forward only the parent grid whose schedule the
                # preemption interrupted; the others run their full schedule
                resume_kwargs = {"start_epoch": int(resume.get("epoch", 0)),
                                 "resume_best": resume}
                resume = None
            result = train(
                proc / "train" / "images", proc / "train" / "masks", state, loop_cfg,
                checkpoint_path=_master_checkpoint_path(cfg),
                val_img_dir=proc / "val" / "images", val_mask_dir=proc / "val" / "masks",
                vgg=vgg, image_size=_image_size(cfg), preempt_extra={"parent": parent},
                record_config=cfg.raw, **resume_kwargs,
            )
            state = result.pop("state")
            metrics[parent] = result
            successful.append(parent)
        except TrainingPreempted:
            # not a per-parent failure: the loop saved preempted.pth
            raise
        except Exception as e:
            logger.exception("parent %s failed: %s", parent, e)
            failed.append(parent)

    # final master checkpoint + timestamped copy (main_pipeline.py:386-412)
    ckpt_path = _master_checkpoint_path(cfg)
    ckpt_path.parent.mkdir(parents=True, exist_ok=True)
    export_pth(
        ckpt_path, state,
        epoch=max((m.get("final_epoch", 0) for m in metrics.values()), default=0),
        config=cfg.raw,
        extra={"processed_grids": successful, "metrics": metrics,
               "vgg_weights_provenance": vgg_provenance},
    )
    stamp = time.strftime("%Y%m%d_%H%M%S")
    shutil.copy2(ckpt_path, ckpt_path.parent / f"master_checkpoint_{stamp}.pth")
    with open(ckpt_path.parent / f"training_metrics_{stamp}.json", "w") as f:
        json.dump({"successful": successful, "failed": failed, "metrics": metrics},
                  f, indent=2, default=str)
    logger.info("training done: %d grids ok, %d failed", len(successful), len(failed))
    return bool(successful)


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


def run_human_guided_training_mode(
    cfg, input_model: Optional[str] = None, target_grid: Optional[str] = None,
    device="cuda",
) -> bool:
    from ..data.dataset import DirectMatchDataset
    from ..portal import (
        PortalClient,
        fetch_annotations_for_grid,
        match_human_and_system_masks,
        validate_dataset,
    )
    from ..training.checkpoint import save_pth
    from ..training.human_guided import HumanGuidedTrainer
    from ..utils.weights import generator_architecture, load_generator

    ckpt_dir = Path(cfg.evaluation.checkpoint_dir) / "human_guided"
    hg_preempted = ckpt_dir / "preempted.pth"
    # source_model is the model the fine-tune started from, also across a
    # resume: the preempted.pth is removed when the run completes
    source_model = Path(input_model) if input_model else _master_checkpoint_path(cfg)
    resumed_from_preemption = hg_preempted.exists()
    if resumed_from_preemption:
        logger.warning("resuming human-guided training from preempted checkpoint %s",
                       hg_preempted)
        model_path = hg_preempted
    else:
        model_path = source_model
    if not model_path.exists():
        logger.error("no model for human-guided training: %s", model_path)
        return False

    grid = target_grid
    if grid is None and experiment_mode():
        zips = sorted(Path(cfg.data.input_zip_folder).glob("*.zip"))
        if zips:
            grid = zips[0].stem.upper()
    if grid is None:
        grid = input("Enter grid square for human-guided training: ").strip().upper()
    if not grid:
        logger.error("no grid square specified")
        return False

    client = PortalClient(cfg.portal.base_url, cfg.portal.api_key) if cfg.portal.base_url \
        else None
    if client is not None:
        try:
            fetch_annotations_for_grid(grid, client, cfg)
        except Exception as e:
            logger.warning("portal fetch failed (%s); using local files", e)

    pairs = match_human_and_system_masks(grid, cfg)
    if not pairs:
        logger.error("no matched annotation pairs for %s", grid)
        return False
    dataset = DirectMatchDataset(pairs, size=_image_size(cfg))
    if not validate_dataset(dataset):
        return False

    G = load_generator(model_path, device)
    vgg, vgg_provenance = _load_vgg(cfg, device)
    result = HumanGuidedTrainer(cfg).train(G, dataset, checkpoint_dir=ckpt_dir, vgg=vgg)

    # the generator-only master with its provenance (main_pipeline.py:705-737)
    generator = G.state_dict()
    ckpt = {
        "generator_state_dict": generator,
        "architecture": generator_architecture(generator),
        "human_guided": True,
        "source_model": str(source_model),
        "resumed_from_preemption": resumed_from_preemption,
        "grid_square": grid,
        "best_loss": result["best_loss"],
        "config": cfg.raw,
        "vgg_weights_provenance": vgg_provenance,
    }
    master = _master_checkpoint_path(cfg)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    save_pth(master.parent / f"master_model_human_guided_{stamp}.pth", ckpt)
    save_pth(master, ckpt)
    logger.info("human-guided training complete: best_loss=%s", result["best_loss"])

    if client is not None and experiment_mode():
        try:
            names = [Path(p["human_mask_path"]).name for p in pairs]
            client.delete_processed_annotations(grid, names, confirm=True)
        except Exception as e:
            logger.warning("portal cleanup failed: %s", e)
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="TERRA-GAN pipeline (PyTorch, CUDA)"
    )
    parser.add_argument(
        "--mode", required=True,
        choices=["train", "evaluate", "human_guided_train"],
        help="train, evaluate or human_guided_train",
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
    if args.mesh:
        logger.error("--mesh is not ported yet: the PyTorch port runs on one device")
        return NOT_PORTED_EXIT
    cfg = _load_config(args.config)
    if cfg.evaluation.quant is not None:
        logger.error("evaluation.quant (%s) is not ported yet: the PyTorch port "
                     "evaluates in fp32", cfg.evaluation.quant)
        return NOT_PORTED_EXIT
    if _bf16_requested(cfg):
        logger.error("training.compute_dtype (%s) is not ported yet: the PyTorch port "
                     "runs in fp32", cfg.raw["training"]["compute_dtype"])
        return NOT_PORTED_EXIT
    if args.mode == "train" and cfg.training.qat_tail.steps > 0:
        logger.error("training.qat_tail is not ported yet: the PyTorch port trains "
                     "without the QAT tail")
        return NOT_PORTED_EXIT
    if not args.no_tracking and cfg.experiment_tracking.enabled:
        logger.warning("experiment tracking is not ported yet: this run is not tracked")
    if args.mode == "train" and cfg.training.async_checkpoint:
        logger.warning("training.async_checkpoint is not ported yet: checkpoints are "
                       "written synchronously")

    from ..training.loop import TrainingPreempted
    from ..utils.device import resolve_device

    device = resolve_device(args.device)  # no CUDA for the default device raises here
    try:
        if args.mode == "train":
            ok = run_training_mode(cfg, args.input_model, device)
        elif args.mode == "evaluate":
            ok = run_evaluation_mode(cfg, args.input_model, args.grid, device)
        else:
            ok = run_human_guided_training_mode(cfg, args.input_model, args.grid, device)
    except TrainingPreempted as e:
        logger.warning("run preempted at epoch %s; latest state saved to %s — re-run "
                       "the same command to resume (exit %d)", e.epoch, e.checkpoint,
                       PREEMPTED_EXIT)
        return PREEMPTED_EXIT
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
