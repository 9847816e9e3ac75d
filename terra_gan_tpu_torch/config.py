"""Training configuration with the JAX package's defaults (terra_gan_tpu/config.py:87-108).

A flat dataclass for the initial (adversarial) training: the JAX
package's typed config reads YAML, which the card's machine lacks, so
the fields the train loop reads are re-stated here with the same
defaults. ``boundary`` is the weight the reference actually trains with:
its criterion is built without a boundary weight, so the term runs at
the class default 0.5 whatever the YAML says (the JAX package's
``faithful_boundary_default``, config.py:145-149, :220-222).
"""

from __future__ import annotations

from dataclasses import dataclass

from .losses import InpaintingLossConfig


@dataclass
class TrainingConfig:
    epochs: int = 100
    batch_size: int = 32
    learning_rate: float = 2e-4  # both Adams (main_pipeline.py:214-221, train.py:138-147)
    log_interval: int = 10  # batches between logged batch metrics (train.py:229)
    checkpoint_interval: int = 5  # epochs between periodic checkpoints (train.py:400)
    perceptual: float = 0.1
    tv: float = 0.1
    boundary: float = 0.5

    def loss_config(self) -> InpaintingLossConfig:
        return InpaintingLossConfig(
            perceptual_weight=self.perceptual, tv_weight=self.tv,
            boundary_weight=self.boundary,
        )
