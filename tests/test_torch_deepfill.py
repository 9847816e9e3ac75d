"""DeepFill v2's generator in the port, against the benchmark's plain reference.

On the CPU at 128^2 with ``cnum`` 8 (the attention over 16^2 = 256 keys)
and the benchmark's seeded weights: the port's ``DeepFillV2Generator``
against ``torch_bench/reference/deepfill.py`` (written from the
published equations) in train and eval mode, x1 and the composite; the
G objective with its coarse term and every leaf's gradient; the
contextual attention against a loop over (query, key) pairs, and a key
whose patch touches the hole at weight 0; TF "SAME" padding at stride 2
against a hand-padded conv; the counters and ranges of a forward; the
published sizes; checkpoints and the config's ``model.generator``;
BatchedInpainter and a HumanGuidedTrainer step on a DeepFill master; the
CLI's train, evaluate and human-guided modes on a tiny DeepFill; and
the objective of the other two generators bitwise as it was.
"""

from __future__ import annotations

import copy
import logging
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from terra_gan_tpu_torch.cli import main_pipeline
from terra_gan_tpu_torch.config import Config
from terra_gan_tpu_torch.losses import InpaintingLossConfig, inpainting_loss
from terra_gan_tpu_torch.models.deepfill import (
    DEEPFILL_V2,
    ContextualAttention,
    DeepFillV2Generator,
    GenConv,
    sizes_from_state,
)
from terra_gan_tpu_torch.models.discriminator import Discriminator
from terra_gan_tpu_torch.models.generator import PConvUNet
from terra_gan_tpu_torch.models.lama import FFCResNetGenerator
from terra_gan_tpu_torch.models.vgg import VGG16Features
from terra_gan_tpu_torch.parallel.infer import BatchedInpainter
from terra_gan_tpu_torch.training.checkpoint import export_pth
from terra_gan_tpu_torch.training.human_guided import HumanGuidedTrainer
from terra_gan_tpu_torch.training.state import GANTrainState, adam
from terra_gan_tpu_torch.training.step import bce_with_logits, generator_objective
from terra_gan_tpu_torch.utils import weights
from terra_gan_tpu_torch.utils.weights import (
    generator_architecture,
    init_generator,
    load_generator,
)
from torch_bench import compare, work_deepfill
from torch_bench.drivers.deepfill_train import seeded_generator
from torch_bench.reference import deepfill as reference
from torch_bench.reference import models as ref_models
from torch_bench.weights import seeded_state

CNUM, HW, BATCH = 8, 128, 2
CPU = torch.device("cpu")
W = {"perceptual": 0.1, "tv": 0.1, "boundary": 0.5}
# fp32 round-off of one conv's sum is about 1e-7 of its terms; 17 layers at
# weights that keep the activations' size pass it on undamped to x1 (1e-5
# of its range), and the attention's softmax at scale 10 over fused scores
# sharpens it tenfold in the refined output (the reference in TF32 reads
# 1e-1 in both)
FORWARD_ATOL = {"x1": 1e-5, "refined": 1e-4}


def batch(seed: int = 3, n: int = BATCH):
    """Tiles with rectangular holes (a quarter of the area at most)."""
    g = torch.Generator().manual_seed(seed)
    image = torch.rand(n, HW, HW, 1, generator=g)
    mask = torch.ones(n, HW, HW, 1)
    for i in range(n):
        y, x = torch.randint(0, HW // 2, (2,), generator=g).tolist()
        mask[i, y : y + HW // 3, x : x + HW // 4] = 0.0
    return {"image": image, "mask": mask}


@pytest.fixture(scope="module")
def state():
    return seeded_generator(CNUM, 11, CPU)


def port(state) -> DeepFillV2Generator:
    G = DeepFillV2Generator(CNUM)
    G.load_state_dict(state)
    return G


def nchw(t):
    return t.permute(0, 3, 1, 2)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_matches_the_reference(state, train):
    b = batch()
    x, m = b["image"] * b["mask"], b["mask"]
    with torch.no_grad():
        got, x1 = port(state).train(train).forward_stages(x, m)
        want, want_x1 = reference.generator(state, nchw(b["image"]), nchw(m))
    torch.testing.assert_close(x1, want_x1.permute(0, 2, 3, 1), atol=FORWARD_ATOL["x1"], rtol=0)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), atol=FORWARD_ATOL["refined"],
                               rtol=0)
    assert torch.equal(port(state)(x, m).detach(), got)  # forward is forward_stages' first
    assert torch.equal(got[m > 0], x[m > 0])  # the composite keeps the kept pixels
    assert float(got[m == 0].std()) > 0.05  # the fill is not flat: it shows the arithmetic
    assert float(x1.std()) > 0.1


def _objective_parts(G, D, vgg, b):
    gan = GANTrainState.create(G, D)
    return gan, generator_objective(gan, b, vgg, InpaintingLossConfig())


def test_the_objective_and_every_leafs_gradient_match_the_reference(state):
    d_state = seeded_state("discriminator", 8, 12, CPU)
    v_state = seeded_state("vgg", 0, 13, CPU)
    D = Discriminator(8)
    D.load_state_dict(d_state)
    vgg = VGG16Features()
    vgg.load_state_dict(v_state)
    b = batch(4)
    G = port(state).train()
    _, (total, _, comps, _) = _objective_parts(G, D, vgg, b)
    total.backward()

    p = {k: v.clone().requires_grad_() for k, v in state.items()}
    real, mask = nchw(b["image"]), nchw(b["mask"])
    gen, x1 = reference.generator(p, real, mask)
    coarse = reference.coarse_l1(x1, real)
    want = ref_models.inpainting_loss(v_state, gen, real, mask, W) + coarse
    want = want + ref_models.bce_logits(ref_models.discriminator(d_state, gen), 1.0)
    want.backward()
    coarse, got_coarse = float(coarse.detach()), float(comps["coarse_l1"].detach())
    assert abs(got_coarse - coarse) <= 1e-6 * coarse
    assert compare.loss_gap([float(total.detach())], [float(want.detach())]) < 1e-6
    leaves = dict(G.named_parameters())
    assert set(leaves) == set(p)
    got = compare.norms({k: v.grad for k, v in leaves.items()})
    ref = compare.norms({k: v.grad for k, v in p.items()})
    # the gradient's round-off against the median leaf (the reference in TF32 reads 1e1)
    assert compare.leaf_gap(got, ref) < 1e-3
    for k, leaf in leaves.items():
        scale = max(float(p[k].grad.abs().max()), 1e-3)
        torch.testing.assert_close(leaf.grad, p[k].grad, atol=2e-3 * scale, rtol=0, msg=k)


def _attention_by_loops(f, b, hole, scale=10.0):
    """CA of one image in float64 by its definition, pair by pair."""
    c, height, width = b.shape
    fd, bd, md = f[:, ::2, ::2], b[:, ::2, ::2], hole[0, ::2, ::2]
    h, w = fd.shape[1:]
    length = h * w

    def patch(x, y0, x0, k, pad):
        out = torch.zeros(x.shape[0], k, k, dtype=x.dtype)
        for u in range(k):
            for v in range(k):
                yy, xx = y0 + u - pad, x0 + v - pad
                if 0 <= yy < x.shape[1] and 0 <= xx < x.shape[2]:
                    out[:, u, v] = x[:, yy, xx]
        return out.flatten()

    q = torch.stack([patch(fd, p // w, p % w, 3, 1) for p in range(length)])
    keys = torch.stack([patch(bd, p // w, p % w, 3, 1) for p in range(length)])
    keys = keys / keys.norm(dim=1, keepdim=True).clamp_min(1e-4)
    s = q @ keys.t()

    def fused(s, index, back):
        out = torch.zeros_like(s)
        for p in range(length):
            for q_ in range(length):
                for d in (-1, 0, 1):
                    pp, qq = index(p) + d, index(q_) + d
                    if 0 <= pp < length and 0 <= qq < length:
                        out[p, q_] += s[back(pp), back(qq)]
        return out

    s = fused(s, lambda p: p, lambda t: t)  # row-major: y w + x
    s = fused(s, lambda p: (p % w) * h + p // w, lambda t: (t % h) * w + t // h)  # x h + y
    valid = torch.tensor([float(patch(md[None], p // w, p % w, 3, 1).sum() == 0)
                          for p in range(length)], dtype=s.dtype)
    a = torch.softmax(scale * s * valid, dim=1) * valid
    out = torch.zeros(c, height + 2, width + 2, dtype=b.dtype)
    for p in range(length):  # query p pastes sum_q a[p, q] * (key q's 4x4 patch of b)
        y, x = 2 * (p // w), 2 * (p % w)
        for q_ in range(length):
            ky, kx = 2 * (q_ // w), 2 * (q_ % w)
            block = F.pad(b, (1, 1, 1, 1))[:, ky : ky + 4, kx : kx + 4]
            out[:, y : y + 4, x : x + 4] += a[p, q_] * block
    return out[:, 1:-1, 1:-1] / 4.0, a


def test_contextual_attention_against_the_pairs_by_definition():
    g = torch.Generator().manual_seed(7)
    f = torch.randn(1, 3, 12, 16, generator=g, dtype=torch.float64)  # 6 x 8 queries and keys
    hole = torch.zeros(1, 1, 12, 16, dtype=torch.float64)
    hole[..., 2:6, 9:13] = 1.0
    ca = ContextualAttention().double()
    got = ca(f, f, hole)
    want, a = _attention_by_loops(f[0], f[0], hole[0])
    torch.testing.assert_close(ca.weights(f, f, hole)[0], a, atol=1e-12, rtol=0)
    torch.testing.assert_close(got[0], want, atol=1e-12, rtol=0)


def test_a_key_whose_patch_touches_the_hole_gets_weight_0():
    g = torch.Generator().manual_seed(8)
    f = 0.002 * torch.randn(2, 4, 16, 16, generator=g)  # small scores: a soft softmax
    hole = torch.zeros(2, 1, 16, 16)
    hole[0, 0, 6, 8] = 1.0  # one hole pixel on the downsampled grid: (3, 4)
    a = ContextualAttention().weights(f, f, hole)
    touched = [y * 8 + x for y in (2, 3, 4) for x in (3, 4, 5)]
    assert float(a[0][:, touched].abs().max()) == 0.0
    others = [k for k in range(64) if k not in touched]
    assert float(a[0][:, others].min()) > 0.0
    # the masked scores enter the softmax at 0, as published: the rest share less than 1
    assert bool((a[0].sum(1) < 1.0).all())
    torch.testing.assert_close(a[1].sum(1), torch.ones(64))  # the other image: no hole, no mask
    hole[0, 0, 7, 9] = 1.0  # off the downsampled grid: keys see only every other pixel
    torch.testing.assert_close(ContextualAttention().weights(f, f, hole), a)


@pytest.mark.parametrize("side", [16, 17])
def test_same_padding_at_stride_2_against_a_hand_padded_conv(side):
    conv = GenConv(3, 8, 3, stride=2, act=None)
    x = torch.randn(2, 3, side, side, generator=torch.Generator().manual_seed(side))
    pad = (0, 1, 0, 1) if side % 2 == 0 else (1, 1, 1, 1)  # TF: the odd pixel after
    want = F.conv2d(F.pad(x, pad), conv.weight, conv.bias, stride=2)
    assert conv(x).shape[-1] == -(-side // 2)
    torch.testing.assert_close(conv(x), want, atol=1e-6, rtol=0)
    gated = GenConv(3, 8, 3, stride=2)
    gated.load_state_dict(conv.state_dict())
    feature, gate = want.chunk(2, 1)
    torch.testing.assert_close(gated(x), F.elu(feature) * torch.sigmoid(gate), atol=1e-6,
                               rtol=0)
    dilated = GenConv(3, 8, 3, rate=4, act=None)
    want = F.conv2d(F.pad(x, (4, 4, 4, 4)), dilated.weight, dilated.bias, dilation=4)
    torch.testing.assert_close(dilated(x), want, atol=1e-6, rtol=0)


def test_counters_and_ranges_of_a_forward(state):
    G = port(state)
    b = batch()
    calls, scores = ContextualAttention.calls, ContextualAttention.scores
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        G(b["image"] * b["mask"], b["mask"])
    assert ContextualAttention.calls - calls == 1
    assert ContextualAttention.scores - scores == BATCH * (HW // 8) ** 4
    names = [e.name for e in prof.events()]
    assert names.count("tg.df_coarse") == names.count("tg.df_refine") == 1
    assert names.count("tg.ctx_attn") == 1
    with pytest.raises(ValueError, match="divide by 8"):
        G(torch.zeros(1, 60, 64, 1), torch.ones(1, 60, 64, 1))


def test_the_published_sizes():
    G = init_generator(64, torch.Generator().manual_seed(0), "cpu", arch="deepfill_v2")
    assert G.sizes == DEEPFILL_V2 == {"cnum": 48}
    assert sum(p.numel() for p in G.parameters()) == work_deepfill.parameters() == 4_044_842
    assert len([m for m in G.modules() if isinstance(m, GenConv)]) == 42
    assert len([m for m in G.modules() if isinstance(m, GenConv) and m.act]) == 40
    assert G.pmconv6.out_channels == 192 and G.pmconv6.act == "relu"
    assert G.allconv11.in_channels == 192  # the two branches' 96 + 96
    assert sizes_from_state(G.state_dict()) == DEEPFILL_V2
    spec = reference.generator_spec(48)
    assert [(k, tuple(s)) for k, s, _ in spec] == [(k, tuple(v.shape))
                                                   for k, v in G.state_dict().items()]


def tiny_deepfill(monkeypatch):
    """``init_generator``'s DeepFill cut to ``cnum`` 8."""
    monkeypatch.setattr(weights, "DEEPFILL_V2", {"cnum": CNUM})


def test_checkpoints_record_and_load_a_deepfill(tmp_path, monkeypatch):
    tiny_deepfill(monkeypatch)
    g = torch.Generator().manual_seed(1)
    G = init_generator(8, g, "cpu", arch="deepfill_v2")
    assert generator_architecture(G.state_dict()) == "deepfill_v2"
    assert generator_architecture(PConvUNet(8).state_dict()) == "pconv_unet"
    assert generator_architecture(FFCResNetGenerator(8, 3, 1).state_dict()) == "big_lama"
    gan = GANTrainState.create(G, Discriminator(8))
    export_pth(tmp_path / "master.pth", gan)
    master = torch.load(tmp_path / "master.pth", weights_only=True)
    assert master["architecture"] == "deepfill_v2"
    sd = G.state_dict()
    torch.save({"model_state_dict": sd}, tmp_path / "hg.pth")
    torch.save(sd, tmp_path / "raw.pth")
    for name in ("master.pth", "hg.pth", "raw.pth"):
        back = load_generator(tmp_path / name, "cpu")
        assert isinstance(back, DeepFillV2Generator) and not back.training
        assert back.sizes == {"cnum": CNUM}
        assert all(torch.equal(v, back.state_dict()[k]) for k, v in sd.items())


def test_model_generator_in_the_config():
    cfg = Config.from_dict({"model": {"generator": "deepfill_v2"}})
    assert cfg.model.generator == "deepfill_v2"
    with pytest.raises(ValueError, match="model.generator"):
        Config.from_dict({"model": {"generator": "deepfill"}})


def test_batched_inpainter_on_a_deepfill_master(state, tmp_path):
    G = port(state)
    export_pth(tmp_path / "master.pth", GANTrainState.create(G, Discriminator(8)))
    b = batch(5, n=3)
    images = (b["image"].numpy() * 255).astype(np.uint8)
    masks = (b["mask"].numpy() * 255).astype(np.uint8)
    got = BatchedInpainter(load_generator(tmp_path / "master.pth", "cpu"), "cpu", chunk=3)(
        images, masks)
    x = torch.from_numpy(images).float() / 255.0
    m = torch.from_numpy(masks > 0).float()
    with torch.no_grad():
        want = G.eval()(x * m, m).numpy()
    np.testing.assert_array_equal(got, want)
    u8 = BatchedInpainter(G, "cpu", chunk=2, quantize_uint8=True)(images, masks)
    assert u8.dtype == np.uint8 and u8.shape == images.shape


def test_one_human_guided_step_on_a_deepfill(state):
    G = port(state).train()
    vgg = VGG16Features()
    vgg.load_state_dict(seeded_state("vgg", 0, 13, CPU))
    opt = adam(G.parameters(), 1e-4)
    before = {k: v.clone() for k, v in G.state_dict().items()}
    b = batch(6)
    human = torch.zeros_like(b["mask"])
    human[:, 10:40, 10:40] = 1.0
    loss, _ = HumanGuidedTrainer(Config()).make_step(G, opt)({**b, "human_mask": human}, vgg)
    assert np.isfinite(float(loss)) and float(loss) > 0
    moved = [k for k, v in G.state_dict().items() if not torch.equal(v, before[k])]
    assert set(moved) == set(before)  # Adam's first step moves every leaf


@pytest.mark.parametrize("arch", ["pconv_unet", "big_lama"])
def test_the_other_generators_objective_is_bitwise_as_before(arch):
    """The objective as it was written before the coarse term: one forward,
    InpaintingLoss plus BCE(D(gen), 1), on copies of the same models."""
    g = torch.Generator().manual_seed(21)
    if arch == "pconv_unet":
        G = init_generator(8, g, "cpu").train()
    else:
        G = FFCResNetGenerator(ngf=8, n_downsampling=3, n_blocks=1).train()
    D = Discriminator(8)
    vgg = VGG16Features()
    vgg.load_state_dict(seeded_state("vgg", 0, 13, CPU))
    b = {k: v[:, :64, :64] for k, v in batch(9).items()}
    G2, D2 = copy.deepcopy(G), copy.deepcopy(D)
    _, (total, gen, comps, g_adv) = _objective_parts(G, D, vgg, b)
    total.backward()

    real, mask = b["image"], b["mask"]
    old_gen = G2(real * mask, mask)
    recon, old_comps = inpainting_loss(old_gen, real, mask, vgg, InpaintingLossConfig())
    old_adv = bce_with_logits(D2(old_gen), 1.0)
    (recon + old_adv).backward()
    assert "coarse_l1" not in comps and set(comps) == set(old_comps)
    assert torch.equal(total, recon + old_adv) and torch.equal(g_adv, old_adv)
    assert torch.equal(gen, old_gen)
    assert all(torch.equal(v, old_comps[k]) for k, v in comps.items())
    for (k, p), (_, p2) in zip(list(G.named_parameters()) + list(D.named_parameters()),
                               list(G2.named_parameters()) + list(D2.named_parameters())):
        assert (p.grad is None and p2.grad is None) or torch.equal(p.grad, p2.grad), k


# ------------------------------------------------------------------ CLI ----

@pytest.fixture()
def root_logging():
    """The CLI replaces the root logger's handlers; give the next test the ones it had."""
    handlers, level = logging.root.handlers[:], logging.root.level
    yield
    for h in logging.root.handlers[:]:
        if h not in handlers:
            logging.root.removeHandler(h)
            h.close()
    for h in handlers:
        if h not in logging.root.handlers:
            logging.root.addHandler(h)
    logging.root.setLevel(level)


def test_cli_trains_evaluates_and_fine_tunes_a_tiny_deepfill(tmp_path, monkeypatch,
                                                            root_logging):
    from PIL import Image
    from test_torch_train_mode import CONFIG, workspace

    config = CONFIG.replace("training:\n", "model:\n  generator: deepfill_v2\ntraining:\n")
    config = config.replace("      epochs: 2\n", "      epochs: 1\n")
    monkeypatch.chdir(workspace(tmp_path, config))
    monkeypatch.setenv("EXPERIMENT_MODE", "true")
    tiny_deepfill(monkeypatch)

    def cli(mode, *args):
        return main_pipeline.main(["--mode", mode, "--device", "cpu", *args])

    assert cli("train") == 0
    master = torch.load("ckpts/master_checkpoint.pth", weights_only=True)
    assert master["architecture"] == "deepfill_v2"
    assert sizes_from_state(master["generator_state_dict"]) == {"cnum": CNUM}
    assert cli("evaluate") == 0
    tests = sorted(Path("data/processed/NJ00/test/images").glob("*.png"))
    written = sorted(Path("data/output").rglob("*_inpainted.png"))
    assert len(tests) == 3 and len(written) == 3
    hdir = Path("data/output/NJ00/human_annotation_masks")
    hdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for p in tests:
        human = ((rng.random((64, 64)) > 0.8) * 255).astype(np.uint8)
        Image.fromarray(human).save(hdir / f"NJ00_colored_{p.stem}_u1a2_mask.png")
    before = master["generator_state_dict"]
    assert cli("human_guided_train", "--grid", "NJ00") == 0
    tuned = torch.load("ckpts/master_checkpoint.pth", weights_only=True)
    assert tuned["human_guided"] is True and tuned["architecture"] == "deepfill_v2"
    # the workspace's masks keep every pixel, so the composite is the tile and
    # the loss 0: test_one_human_guided_step_on_a_deepfill checks an update
    assert set(tuned["generator_state_dict"]) == set(before)


def test_a_small_deepfill_cell_under_profile_steps():
    import argparse
    import importlib.util
    import time

    spec = importlib.util.spec_from_file_location(
        "profile_steps", Path(__file__).resolve().parents[1] / "profile_steps.py")
    ps = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ps)
    args = argparse.Namespace(workload="deepfill.train-b16", seed=2**31 + 9, seconds=1.0,
                              trace=0)
    small = {"config": {"cnum": CNUM, "image_size": 64, "discriminator_width": 8,
                        "batch_size": {"gan": 4}},
             "traffic": {"tiles": 15}}
    rep = ps.profile_cell(args, time.perf_counter(), torch.device("cpu"), small)
    steps = rep["counts"]["steps"]
    assert rep["correct"] and steps >= 3
    for name in ps.DEEPFILL_RANGES:
        assert rep["ranges"][name] == steps
    assert rep["per_step"]["ctx_attn_calls"] == 1  # one G forward a step
    assert rep["per_step"]["ctx_attn_scores"] == pytest.approx(
        rep["counts"]["samples"] / steps * (64 // 8) ** 4)
    assert set(rep["per_step"]["deepfill_forward_ms"]) == set(ps.DEEPFILL_RANGES)
