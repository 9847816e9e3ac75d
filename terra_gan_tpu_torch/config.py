"""Typed configuration: the JAX package's schema (terra_gan_tpu/config.py:23-388).

One typed schema over the reference's ``config.yaml`` shape, with the
same sections, fields, defaults, unknown-key warnings and raw dict as the
JAX package's, so that one YAML file configures both packages. The file
is read with ``utils.yaml_lite``: the card's machine has no PyYAML.

Some fields configure parts of the JAX package the port has not ported
(remat, the async checkpoint, feed workers, the QAT tail, quantised
evaluation): they are read and kept so that a config round-trips, and
the CLI refuses the ones whose absence would change a result
(``evaluation.quant``, and ``training.compute_dtype`` when it asks for
bf16).

The port adds one section of its own, ``model``: ``model.generator``
picks the generator architecture that ``--mode train`` builds,
"pconv_unet" (the default, the reference's), "big_lama" (Big-LaMa's
FFC ResNet, ``models/lama.py``) or "deepfill_v2" (DeepFill v2's
gated-convolution generator with contextual attention,
``models/deepfill.py``); a checkpoint's own keys say which one it holds
wherever one is loaded.

``LoopConfig`` is the flat view of ``TrainingConfig`` that the port's
training loop reads (``LoopConfig.from_training``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

from .losses import InpaintingLossConfig
from .utils import yaml_lite

logger = logging.getLogger(__name__)

# the JAX package's quantised evaluation modes (terra_gan_tpu/ops/quant.py:251)
QUANT_MODES = ("w8a8", "w8a8_resident", "w8a8_resident_full")
# the generator architectures ``model.generator`` names
GENERATORS = ("pconv_unet", "big_lama", "deepfill_v2")


def _get(d: Optional[Dict], *keys, default=None):
    cur: Any = d or {}
    for k in keys:
        if not isinstance(cur, dict) or k not in cur or cur[k] is None:
            return default
        cur = cur[k]
    return cur


# Keys read anywhere (typed schema + raw-dict reads) per section. Only
# the sections with a fixed schema are checked; mask_processing / data /
# portal stay free-form like the reference treats them.
_KNOWN_KEYS = {
    "training": {
        "loss_weights", "modes", "faithful_boundary_default", "remat",
        "vgg_remat", "remat_stages", "async_checkpoint", "feed_workers",
        "vgg_weights_path", "compute_dtype", "log_interval", "qat_tail",
    },
    "training.loss_weights": {"perceptual", "tv", "boundary"},
    "training.qat_tail": {"steps", "learning_rate"},
    "training.modes": {"initial", "human_guided"},
    "training.modes.initial": {
        "epochs", "batch_size", "learning_rate", "log_interval",
        "checkpoint_interval",
    },
    "training.modes.human_guided": {
        "epochs", "batch_size", "learning_rate", "human_feedback_weight",
        "base_loss_weight",
    },
    "evaluation": {
        "metrics", "sampling", "checkpoint_dir", "checkpoint_file", "quant",
    },
    "evaluation.metrics": {
        "iou_threshold", "precision_threshold", "recall_threshold",
        "boundary_size",
    },
    "model": {"generator"},
}


def _warn_unknown_keys(d: Dict[str, Any]) -> None:
    """Warn (never fail) about config keys no code path reads: a typo
    like `remat_stage` would otherwise silently fall back to the default."""
    import difflib

    for section, known in _KNOWN_KEYS.items():
        sub = d
        for part in section.split("."):
            sub = sub.get(part) if isinstance(sub, dict) else None
            if sub is None:
                break
        if not isinstance(sub, dict):
            continue
        for key in sub:
            if key in known:
                continue
            hint = difflib.get_close_matches(key, known, n=1)
            logger.warning(
                "config: unknown key %s.%s is not read by anything%s",
                section, key,
                f" — did you mean {hint[0]!r}?" if hint else "",
            )


@dataclass
class LossWeights:
    perceptual: float = 0.1
    tv: float = 0.1
    boundary: float = 0.0  # config.yaml:5 ships 0; see faithful_boundary_default

    @classmethod
    def from_dict(cls, d):
        return cls(
            perceptual=_get(d, "perceptual", default=0.1),
            tv=_get(d, "tv", default=0.1),
            boundary=_get(d, "boundary", default=0.0),
        )


@dataclass
class InitialTraining:
    epochs: int = 100
    batch_size: int = 32
    learning_rate: float = 2e-4  # main_pipeline.py:216 default
    log_interval: int = 10  # train.py:229 default
    checkpoint_interval: int = 5  # train.py:400 default


@dataclass
class HumanGuidedTraining:
    epochs: int = 20
    batch_size: int = 5
    learning_rate: float = 1e-4
    human_feedback_weight: float = 0.3
    base_loss_weight: float = 0.7


@dataclass
class QATTail:
    """The JAX package's quantization-aware tail fine-tune (not ported)."""

    steps: int = 0
    learning_rate: float = 5e-5


@dataclass
class TrainingConfig:
    loss_weights: LossWeights = field(default_factory=LossWeights)
    initial: InitialTraining = field(default_factory=InitialTraining)
    human_guided: HumanGuidedTraining = field(default_factory=HumanGuidedTraining)
    # Reference quirk (train.py:110-114): initial training constructs its
    # criterion without the boundary weight, so the boundary term always
    # runs at the class default 0.5; the yaml value only gates *logging*.
    # True preserves that behavior; False makes the yaml value real.
    faithful_boundary_default: bool = True
    # the JAX package's memory and feed knobs (not ported)
    remat: bool = False
    vgg_remat: bool = False
    remat_stages: tuple = ()
    async_checkpoint: bool = False
    feed_workers: Optional[int] = None
    qat_tail: QATTail = field(default_factory=QATTail)

    @classmethod
    def from_dict(cls, d):
        modes = _get(d, "modes", default={})
        init = _get(modes, "initial", default={})
        hg = _get(modes, "human_guided", default={})
        return cls(
            loss_weights=LossWeights.from_dict(_get(d, "loss_weights", default={})),
            initial=InitialTraining(
                epochs=_get(init, "epochs", default=100),
                batch_size=_get(init, "batch_size", default=32),
                learning_rate=_get(init, "learning_rate", default=2e-4),
                log_interval=_get(init, "log_interval", default=10),
                checkpoint_interval=_get(init, "checkpoint_interval", default=5),
            ),
            human_guided=HumanGuidedTraining(
                epochs=_get(hg, "epochs", default=20),
                batch_size=_get(hg, "batch_size", default=5),
                learning_rate=_get(hg, "learning_rate", default=1e-4),
                human_feedback_weight=_get(hg, "human_feedback_weight", default=0.3),
                base_loss_weight=_get(hg, "base_loss_weight", default=0.7),
            ),
            faithful_boundary_default=_get(
                d, "faithful_boundary_default", default=True
            ),
            remat=bool(_get(d, "remat", default=False)),
            vgg_remat=bool(_get(d, "vgg_remat", default=False)),
            remat_stages=tuple(_get(d, "remat_stages", default=()) or ()),
            async_checkpoint=bool(
                _get(d, "async_checkpoint", default=False)
            ),
            feed_workers=(
                None if _get(d, "feed_workers") is None
                else int(_get(d, "feed_workers"))
            ),
            qat_tail=QATTail(
                steps=int(_get(d, "qat_tail", "steps", default=0)),
                learning_rate=float(
                    _get(d, "qat_tail", "learning_rate", default=5e-5)
                ),
            ),
        )

    def effective_boundary_weight(self) -> float:
        """Boundary weight actually used during initial training."""
        return 0.5 if self.faithful_boundary_default else self.loss_weights.boundary


@dataclass
class LoopConfig:
    """What ``training.loop.train`` reads, flat: the initial-training mode's
    schedule and the loss weights it actually trains with. A checkpoint
    records it as its ``config``."""

    epochs: int = 100
    batch_size: int = 32
    learning_rate: float = 2e-4  # both Adams (main_pipeline.py:214-221, train.py:138-147)
    log_interval: int = 10  # batches between logged batch metrics
    checkpoint_interval: int = 5  # epochs between periodic checkpoints
    perceptual: float = 0.1
    tv: float = 0.1
    boundary: float = 0.5  # TrainingConfig.effective_boundary_weight()
    feed_workers: Optional[int] = None  # the loaders' producer threads (None: default_feed_workers)

    @classmethod
    def from_training(cls, t: TrainingConfig) -> "LoopConfig":
        init = t.initial
        return cls(
            epochs=init.epochs, batch_size=init.batch_size, learning_rate=init.learning_rate,
            log_interval=init.log_interval, checkpoint_interval=init.checkpoint_interval,
            perceptual=t.loss_weights.perceptual, tv=t.loss_weights.tv,
            boundary=t.effective_boundary_weight(), feed_workers=t.feed_workers,
        )

    def loss_config(self) -> InpaintingLossConfig:
        return InpaintingLossConfig(
            perceptual_weight=self.perceptual, tv_weight=self.tv,
            boundary_weight=self.boundary,
        )


@dataclass
class EvaluationConfig:
    iou_threshold: float = 0.5
    precision_threshold: float = 0.7
    recall_threshold: float = 0.7
    boundary_size: int = 10
    annotation_ratio: float = 0.01
    checkpoint_dir: str = "mvp_gan/checkpoints"
    checkpoint_file: str = "generator_epoch_49.pth"
    # the JAX package's int8 evaluation modes (QUANT_MODES); None = exact
    # fp32. Not ported: the CLI refuses a config that sets it.
    quant: Optional[str] = None

    @classmethod
    def from_dict(cls, d):
        m = _get(d, "metrics", default={})
        quant = _get(d, "quant", default=None)
        if quant is not None and quant not in QUANT_MODES:
            raise ValueError(
                f"evaluation.quant must be one of {QUANT_MODES} or "
                f"unset, got {quant!r}"
            )
        return cls(
            iou_threshold=_get(m, "iou_threshold", default=0.5),
            precision_threshold=_get(m, "precision_threshold", default=0.7),
            recall_threshold=_get(m, "recall_threshold", default=0.7),
            boundary_size=_get(m, "boundary_size", default=10),
            annotation_ratio=_get(d, "sampling", "annotation_ratio", default=0.01),
            checkpoint_dir=_get(d, "checkpoint_dir", default="mvp_gan/checkpoints"),
            checkpoint_file=_get(
                d, "checkpoint_file", default="generator_epoch_49.pth"
            ),
            quant=quant,
        )


@dataclass
class ModelConfig:
    """The port's own section: which generator ``--mode train`` builds."""

    generator: str = "pconv_unet"

    @classmethod
    def from_dict(cls, d):
        generator = _get(d, "generator", default="pconv_unet")
        if generator not in GENERATORS:
            raise ValueError(
                f"model.generator must be one of {GENERATORS}, got {generator!r}"
            )
        return cls(generator=generator)


@dataclass
class PortalConfig:
    base_url: str = ""
    api_key: str = ""

    @classmethod
    def from_dict(cls, d):
        return cls(
            base_url=_get(d, "base_url", default=""),
            api_key=_get(d, "api_key", default=""),
        )


@dataclass
class TrackingConfig:
    enabled: bool = True
    tracking_uri: str = "file:./mlruns"
    experiment_name: str = "dsm_inpainting"
    tags: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d):
        return cls(
            enabled=_get(d, "enabled", default=True),
            tracking_uri=_get(d, "tracking_uri", default="file:./mlruns"),
            experiment_name=_get(d, "experiment_name", default="dsm_inpainting"),
            tags=_get(d, "tags", default={}) or {},
        )


@dataclass
class DataConfig:
    raw_dir: str = "data/raw_data"
    processed_dir: str = "data/processed_data"
    output_dir: str = "data/output"
    input_zip_folder: str = "data/raw_data/input_zip_folder"
    extracted_dir: str = "data/raw_data/extracted"
    models_dir: str = "data/output/models"
    human_annotations_dir: str = "data/human_annotations"
    evaluation_results_dir: str = "data/evaluation_results"
    human_annotation_masks_dir: str = "human_annotation_masks"
    processed_structure: tuple = (
        "metadata", "raw",
        "train/images", "train/masks",
        "test/images", "test/masks",
        "val/images", "val/masks",
    )
    output_structure: tuple = ("inpainted", "colored", "visualization", "masks")

    @classmethod
    def from_dict(cls, d):
        return cls(
            raw_dir=_get(d, "raw_dir", default="data/raw_data"),
            processed_dir=_get(d, "processed_dir", default="data/processed_data"),
            output_dir=_get(d, "output_dir", default="data/output"),
            input_zip_folder=_get(
                d, "input_zip_folder", default="data/raw_data/input_zip_folder"
            ),
            extracted_dir=_get(d, "extracted_dir", default="data/raw_data/extracted"),
            models_dir=_get(d, "models_dir", default="data/output/models"),
            human_annotations_dir=_get(
                d, "human_annotations_dir", default="data/human_annotations"
            ),
            evaluation_results_dir=_get(
                d, "evaluation_results_dir", default="data/evaluation_results"
            ),
            human_annotation_masks_dir=_get(
                d, "human_annotation_masks_dir", default="human_annotation_masks"
            ),
            processed_structure=tuple(
                _get(d, "parent_structure", "processed", default=[
                    "metadata", "raw", "train/images", "train/masks",
                    "test/images", "test/masks", "val/images", "val/masks",
                ])
            ),
            output_structure=tuple(
                _get(d, "parent_structure", "output", default=[
                    "inpainted", "colored", "visualization", "masks",
                ])
            ),
        )


@dataclass
class Config:
    training: TrainingConfig = field(default_factory=TrainingConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    mask_processing: Dict[str, Any] = field(default_factory=dict)
    portal: PortalConfig = field(default_factory=PortalConfig)
    experiment_tracking: TrackingConfig = field(default_factory=TrackingConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        _warn_unknown_keys(d)
        return cls(
            training=TrainingConfig.from_dict(_get(d, "training", default={})),
            evaluation=EvaluationConfig.from_dict(_get(d, "evaluation", default={})),
            mask_processing=_get(d, "mask_processing", default={}) or {},
            portal=PortalConfig.from_dict(_get(d, "portal", default={})),
            experiment_tracking=TrackingConfig.from_dict(
                _get(d, "experiment_tracking", default={})
            ),
            data=DataConfig.from_dict(_get(d, "data", default={})),
            model=ModelConfig.from_dict(_get(d, "model", default={})),
            raw=d,
        )

    @classmethod
    def load(cls, path: str | Path = "config.yaml") -> "Config":
        return cls.from_dict(yaml_lite.load(path) or {})


def load_config(path: str | Path = "config.yaml") -> Config:
    return Config.load(path)
