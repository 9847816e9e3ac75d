"""The GAN train and eval steps (counterpart of terra_gan_tpu/training/step.py).

The reference loop (mvp_gan/src/train.py:177-219), one optimizer step
each for G and D:

  * G objective: InpaintingLoss(gen, real, mask) + BCE(D(gen), 1)
    (train.py:183-204); the reference builds its criterion without a
    boundary weight, so the boundary term runs at 0.5 (the default of
    ``InpaintingLossConfig``). A generator with a coarse stage
    (``forward_stages``: DeepFill v2's) also gives its coarse output x1
    from the same forward, and DeepFill's coarse L1 (``coarse_l1``:
    mean |real - x1| in [-1, 1] units, weight 1) is added to the
    InpaintingLoss and reported as ``g_coarse_l1``.
  * D objective: 0.5 * (BCE(D(real), 1) + BCE(D(gen.detach()), 0))
    (train.py:209-219), on the generator output from before G's update.
    D's fake half is a new forward of the detached output: reusing the
    G step's fake logits would leave D with the real half's gradient
    alone, the fault an earlier JAX revision had (step.py:22-36).
  * D's BatchNorm statistics advance three times a step, in the order
    fake (G step), real, fake (D step); G's once.
  * G's backward also fills D's ``.grad``; D's gradients are zeroed
    before the D backward, as the reference does.

On a card the G forward packs K2's weight planes once and runs its 14
PConv stages on K2's train variant (``fused_pconv_train``), and launches
K1 forward 7 times; its backward launches K1 backward 7 times, and its
convolutions' dgrad and wgrad are cuDNN's.
Metrics are 0-dim tensors on the device, named as the reference's
batch metrics (train.py:246-251); reading them synchronises.

Under a profiler the train step is the range ``tg.gan_step``, holding in
order ``tg.g_forward`` (G's forward), ``tg.loss`` (``inpainting_loss``
with VGG), ``tg.g_adv`` (D on the generated batch and its BCE),
``tg.g_backward``, ``tg.g_adam`` and ``tg.d_step`` (D's two forwards,
its backward and its Adam); G's zero-grad, which launches nothing,
stays before the forward (utils/trace.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..losses import InpaintingLossConfig, inpainting_loss
from ..models.deepfill import COARSE_L1_WEIGHT, coarse_l1
from ..models.vgg import VGG16Features
from ..utils.trace import span
from .state import GANTrainState

Batch = Dict[str, torch.Tensor]


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean BCEWithLogits against a constant 0/1 target, numerically stable."""
    x = logits
    return (x.clamp_min(0.0) - x * target + torch.log1p(torch.exp(-x.abs()))).mean()


def generator_objective(
    state: GANTrainState,
    batch: Batch,
    vgg: Optional[VGG16Features],
    loss_config: InpaintingLossConfig,
    forward: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """(total, gen, loss components, adversarial term) of the G objective.

    ``forward`` is the generator's forward (the generator itself, or its
    ``forward_plain``: the reference a card's kernel path is held to).
    Without one, a generator whose class has ``forward_stages`` runs
    that, and its coarse output's L1 joins the loss as ``coarse_l1``.
    """
    real, mask = batch["image"], batch["mask"]
    stages = None if forward else getattr(type(state.generator), "forward_stages", None)
    with span("tg.g_forward"):
        if stages is None:
            gen, coarse = (forward or state.generator)(real * mask, mask), None
        else:
            gen, coarse = stages(state.generator, real * mask, mask)
    with span("tg.loss"):
        recon, comps = inpainting_loss(gen, real, mask, vgg, loss_config)
        if coarse is not None:
            comps["coarse_l1"] = coarse_l1(coarse, real)
            recon = comps["total"] = recon + COARSE_L1_WEIGHT * comps["coarse_l1"]
    with span("tg.g_adv"):
        g_adv = bce_with_logits(state.discriminator(gen), 1.0)
    return recon + g_adv, gen, comps, g_adv


def make_train_step(loss_config: InpaintingLossConfig = InpaintingLossConfig()):
    """step(state, batch, vgg) -> metrics; batch = {'image', 'mask'} NHWC
    [B,H,W,1] on the state's device, mask 1 = preserved."""

    def step(state: GANTrainState, batch: Batch, vgg: Optional[VGG16Features]):
        with span("tg.gan_step"):
            state.generator.train()
            D = state.discriminator.train()

            state.g_opt.zero_grad(set_to_none=True)
            g_total, gen, comps, g_adv = generator_objective(state, batch, vgg, loss_config)
            with span("tg.g_backward"):
                g_total.backward()
            with span("tg.g_adam"):
                state.g_opt.step()

            with span("tg.d_step"):
                state.d_opt.zero_grad(set_to_none=True)  # G's backward filled them
                fake = gen.detach()
                real_loss = bce_with_logits(D(batch["image"]), 1.0)
                fake_loss = bce_with_logits(D(fake), 0.0)
                d_loss = 0.5 * (real_loss + fake_loss)
                d_loss.backward()
                state.d_opt.step()
            state.step += 1

            metrics = {"g_loss": g_total, "d_loss": d_loss, "real_loss": real_loss,
                       "fake_loss": fake_loss, "g_adv_loss": g_adv}
            metrics.update((f"g_{k}", v) for k, v in comps.items() if k != "total")
            return {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_step(
    loss_config: InpaintingLossConfig = InpaintingLossConfig(),
    torch_faithful_d_mode: bool = True,
):
    """Validation step (train.py:277-303): step(state, batch, vgg) -> (gen, metrics).

    G runs in eval mode (K2, K1 and K3 on a card). The reference quirk is kept
    by default: validation never calls ``discriminator.eval()``
    (train.py:279), so its D forwards run in train mode, normalising by
    the batch and advancing D's running statistics twice per batch; pass
    False for a pure pass with D in eval mode. Both modules get back the
    mode they came in with.
    """

    @torch.no_grad()
    def step(state: GANTrainState, batch: Batch, vgg: Optional[VGG16Features]):
        G, D = state.generator, state.discriminator
        modes = G.training, D.training
        real, mask = batch["image"], batch["mask"]
        try:
            G.eval()
            D.train(torch_faithful_d_mode)
            gen = G(real * mask, mask)
            g_loss, comps = inpainting_loss(gen, real, mask, vgg, loss_config)
            d_loss = 0.5 * (bce_with_logits(D(real), 1.0) + bce_with_logits(D(gen), 0.0))
        finally:
            G.train(modes[0])
            D.train(modes[1])
        metrics = {"val_g_loss": g_loss, "val_d_loss": d_loss}
        metrics.update((f"val_g_{k}", v) for k, v in comps.items() if k != "total")
        return gen, metrics

    return step
