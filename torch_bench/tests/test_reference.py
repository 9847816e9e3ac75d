"""The plain reference against the port's own plain paths on the CPU, at
128^2 and base width 8 (every stage halves evenly down to 1x1).

Tolerances: both sides are float32 with different orders of summation;
with He-normal weights the round-off grows through the U-Net to about
1e-6 of dec2's RMS (on the card 1.5e-6-2.6e-6 at full width), so 1e-5.
A step's losses agree to 1e-5; first gradients, by the worst leaf, to
1e-3 of the leaf's (or the median leaf's) norm.
"""

import numpy as np
import pytest
import torch

from torch_bench import compare, traffic
from torch_bench.reference import models
from torch_bench.reference.steps import TrainReference, eval_forward, nchw
from torch_bench.weights import seeded_state

DEV = torch.device("cpu")
SIDE, WIDTH = 128, 8
WEIGHTS = {"perceptual": 0.1, "tv": 0.1, "boundary": 0.5, "base_loss_weight": 0.7,
           "human_feedback_weight": 0.3}


def tiles(n, seed):
    images, masks = traffic.dsm_tiles(n, SIDE, seed, DEV)
    return images, masks


def float_batch(images, masks, human=None):
    b = {"image": torch.from_numpy(images.astype(np.float32) / 255.0),
         "mask": torch.from_numpy((masks > 0).astype(np.float32))}
    if human is not None:
        b["human_mask"] = torch.from_numpy((human > 0).astype(np.float32))
    return b


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_eval_forward_against_the_ports_plain_path(seed):
    from terra_gan_tpu_torch.models.generator import PConvUNet

    state = seeded_state("generator", WIDTH, seed, DEV)
    model = PConvUNet(WIDTH)
    model.load_state_dict(state)
    model.eval()
    images, masks = tiles(4, seed)
    b = float_batch(images, masks)
    feats = []
    model.dec2.register_forward_hook(lambda mod, a, out: feats.append(out[0]))
    with torch.no_grad():
        got = model.forward_plain(b["image"] * b["mask"], b["mask"])
    want_u8, want_feat = eval_forward(state, torch.from_numpy(images), torch.from_numpy(masks))
    taps = {}
    with torch.no_grad():
        want = models.generator(state, nchw(b["image"]), nchw(b["mask"]), taps=taps)
    assert compare.nrmse(got, want.permute(0, 2, 3, 1)) < 1e-5
    assert compare.nrmse(feats[0], want_feat) < 1e-5
    got_u8 = (got.clamp(0, 1) * 255).to(torch.uint8)
    assert compare.mismatch_share(got_u8, want_u8) < 1e-3
    # the holes spread over the grey range (He-normal weights): the answer sees the arithmetic
    holes = want.permute(0, 2, 3, 1)[b["mask"] == 0]
    assert holes.std() > 0.05


def _port_step(mode, states, lr):
    from terra_gan_tpu_torch.config import Config, LoopConfig
    from terra_gan_tpu_torch.models.discriminator import Discriminator
    from terra_gan_tpu_torch.models.generator import PConvUNet
    from terra_gan_tpu_torch.models.vgg import VGG16Features
    from terra_gan_tpu_torch.training.human_guided import HumanGuidedTrainer
    from terra_gan_tpu_torch.training.state import GANTrainState, adam
    from terra_gan_tpu_torch.training.step import make_train_step

    G = PConvUNet(WIDTH)
    G.load_state_dict(states["generator"])
    vgg = VGG16Features()
    vgg.load_state_dict(states["vgg"])
    if mode == "gan":
        D = Discriminator(WIDTH)
        D.load_state_dict(states["discriminator"])
        state = GANTrainState.create(G, D, lr=lr)
        fn = make_train_step(LoopConfig(learning_rate=lr).loss_config())
        grads, g_step = {}, state.g_opt.step

        def keep_g_grads(*args, **kwargs):  # G's gradients as its Adam gets them
            grads["generator"] = {k: p.grad.clone() for k, p in G.named_parameters()
                                  if p.grad is not None}
            return g_step(*args, **kwargs)

        state.g_opt.step = keep_g_grads

        def step(batch):
            m = fn(state, batch, vgg)
            grads["discriminator"] = {k: p.grad.clone() for k, p in D.named_parameters()
                                      if p.grad is not None}
            return [float(m["g_loss"]), float(m["d_loss"])], grads

        return step
    opt = adam(G.parameters(), lr)
    fn = HumanGuidedTrainer(Config()).make_step(G, opt)

    def step(batch):
        loss, _ = fn(batch, vgg)
        return [float(loss)], {"generator": {k: p.grad.clone() for k, p in G.named_parameters()
                                             if p.grad is not None}}

    return step


@pytest.mark.parametrize("mode", ["gan", "hg"])
def test_train_step_against_the_ports(mode):
    seed = 17
    names = ["generator", "vgg"] + (["discriminator"] if mode == "gan" else [])
    states = {n: seeded_state(n, WIDTH, seed, DEV) for n in names}
    images, masks = tiles(2, seed)
    human = traffic.human_masks(2, SIDE, seed, DEV) if mode == "hg" else None
    batch = float_batch(images, masks, human)
    lr = 2e-4 if mode == "gan" else 1e-4
    got_losses, got_grads = _port_step(mode, states, lr)(batch)
    ref = TrainReference(mode, states["generator"], states["vgg"], WEIGHTS, lr,
                         states.get("discriminator"))
    want_losses = ref.step(batch)
    assert compare.loss_gap(got_losses, want_losses) < 1e-5
    for n, want in ref.grads.items():
        assert set(got_grads[n]) == set(want)
        assert compare.leaf_gap(compare.norms(got_grads[n]), compare.norms(want)) < 1e-3
