"""Big-LaMa's FFC ResNet generator in the port, against the benchmark's plain reference.

On the CPU at 64^2 with ``ngf`` 8, 2 blocks and ratio 0.75, seeded
random weights: the port's ``FFCResNetGenerator`` against
``torch_bench/reference/lama.py`` (written from the published equations)
in train and eval mode, every leaf's gradient, one GAN step through
``make_train_step`` against ``LamaTrainReference``; the Fourier unit
against an explicit DFT-matrix computation in float64 (the ortho norm
and the re/im interleave); the spectral counters and the profiler
ranges of a forward; the published sizes; checkpoints and the config's
``model.generator``; and the CLI's train, evaluate and human-guided
modes on a tiny LaMa.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from terra_gan_tpu_torch.cli import main_pipeline
from terra_gan_tpu_torch.config import Config
from terra_gan_tpu_torch.models.discriminator import Discriminator
from terra_gan_tpu_torch.models.lama import (
    BIG_LAMA,
    FFCResNetGenerator,
    FourierUnit,
    SpectralTransform,
    sizes_from_state,
)
from terra_gan_tpu_torch.models.vgg import VGG16Features
from terra_gan_tpu_torch.training.checkpoint import export_pth
from terra_gan_tpu_torch.training.state import GANTrainState
from terra_gan_tpu_torch.training.step import make_train_step
from terra_gan_tpu_torch.utils import weights
from terra_gan_tpu_torch.utils.weights import init_generator, load_generator
from torch_bench import compare, work_lama
from torch_bench.drivers.lama_train import seeded_generator
from torch_bench.reference import lama as reference
from torch_bench.weights import seeded_state

SIZES = {"ngf": 8, "n_downsampling": 3, "n_blocks": 2, "ratio": 0.75}
HW, BATCH = 64, 2
CPU = torch.device("cpu")
# fp32 round-off of one conv's sum at unit scale is about 1e-7 a term
# over up to 8 * 49 terms; the port and the reference run the same
# operations in the same order (bitwise equal here), and 1e-6 leaves
# room for a conv algorithm that sums in another order
FORWARD_ATOL = 1e-6


def batch(seed: int = 3, n: int = BATCH):
    g = torch.Generator().manual_seed(seed)
    image = torch.rand(n, HW, HW, 1, generator=g)
    mask = (torch.rand(n, HW, HW, 1, generator=g) > 0.3).float()
    return {"image": image, "mask": mask}


@pytest.fixture(scope="module")
def state():
    return seeded_generator(SIZES, 11, CPU)


def port(state, train: bool) -> FFCResNetGenerator:
    G = FFCResNetGenerator(**SIZES)
    G.load_state_dict(state)
    return G.train(train)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_matches_the_reference(state, train):
    b = batch()
    x, m = b["image"] * b["mask"], b["mask"]
    got = port(state, train)(x, m).detach()
    p = {k: v.clone() for k, v in state.items()}
    want = reference.generator(p, b["image"].permute(0, 3, 1, 2), m.permute(0, 3, 1, 2),
                               train).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, atol=FORWARD_ATOL, rtol=0)
    assert torch.equal(got[m > 0], x[m > 0])  # the composite keeps the kept pixels
    assert float(got[m == 0].std()) > 0.05  # the fill is not flat: it shows the arithmetic


def test_gradients_of_every_leaf_match_the_reference(state):
    b = batch(4)
    G = port(state, True)
    G(b["image"] * b["mask"], b["mask"]).square().mean().backward()
    p = {k: v.clone().requires_grad_(v.is_floating_point() and "running" not in k)
         for k, v in state.items()}
    reference.generator(p, b["image"].permute(0, 3, 1, 2), b["mask"].permute(0, 3, 1, 2),
                        True).square().mean().backward()
    leaves = dict(G.named_parameters())
    assert set(leaves) == {k for k, v in p.items() if v.requires_grad}
    for k, leaf in leaves.items():
        # a gradient sums the forward's round-off over the batch's pixels: 1e-5 of
        # the leaf's largest entry, or of 1e-3 for leaves whose gradient is near 0
        scale = max(float(p[k].grad.abs().max()), 1e-3)
        torch.testing.assert_close(leaf.grad, p[k].grad, atol=1e-5 * scale, rtol=0, msg=k)


def test_fourier_unit_is_the_explicit_dft():
    """float64 at 8x8: rfft2 (ortho), [re, im] interleaved per channel, a 1x1
    conv, BN (eval, identity statistics) and ReLU, and the C2R inverse, each
    written as a sum over DFT matrices."""
    c, h, w = 3, 8, 8
    fu = FourierUnit(c).double().eval()
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        fu.conv_layer.weight.copy_(torch.randn(2 * c, 2 * c, 1, 1, generator=g,
                                               dtype=torch.float64))
        fu.bn.running_mean.zero_()
        fu.bn.running_var.fill_(1.0 - fu.bn.eps)
    u = torch.randn(2, c, h, w, generator=g, dtype=torch.float64)
    got = fu(u)

    x = u.numpy()
    ah = np.exp(-2j * np.pi * np.outer(np.arange(h), np.arange(h)) / h)
    aw = np.exp(-2j * np.pi * np.outer(np.arange(w // 2 + 1), np.arange(w)) / w)
    f = np.einsum("kh,bchw,lw->bckl", ah, x, aw) / math.sqrt(h * w)
    s = np.stack([f.real, f.imag], 2).reshape(2, 2 * c, h, w // 2 + 1)  # c0.re, c0.im, ...
    conv = fu.conv_layer.weight[..., 0, 0].detach().numpy()
    s = np.maximum(np.einsum("oi,bikl->bokl", conv, s), 0)
    spec = s[:, 0::2] + 1j * s[:, 1::2]
    # C2R: the half spectrum's columns weighted 1 (0 and W/2) or 2, real part taken
    weight = np.full(w // 2 + 1, 2.0)
    weight[0] = weight[-1] = 1.0
    z = np.einsum("kh,bckl->bchl", ah.conj(), spec)
    want = np.einsum("l,bchl,lw->bchw", weight, z, aw.conj()).real / math.sqrt(h * w)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-12, rtol=0)


def test_spectral_counters_and_ranges_of_a_forward():
    G = FFCResNetGenerator(**SIZES).train()
    b = batch()
    calls, elements = SpectralTransform.calls, SpectralTransform.elements
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        G(b["image"] * b["mask"], b["mask"])
    assert SpectralTransform.calls - calls == 2 * SIZES["n_blocks"]
    dim = SIZES["ngf"] * 2 ** SIZES["n_downsampling"]
    side = HW >> SIZES["n_downsampling"]
    per_call = BATCH * int(dim * SIZES["ratio"]) // 2 * side * side  # rfft2's input: g/2 channels
    assert SpectralTransform.elements - elements == 2 * SIZES["n_blocks"] * per_call
    names = [e.name for e in prof.events()]
    assert names.count("tg.ffc_spectral") == names.count("tg.ffc_local") == 2 * SIZES["n_blocks"]
    assert names.count("tg.lama_down") == names.count("tg.lama_up") == 1


def test_the_published_sizes():
    G = init_generator(64, torch.Generator().manual_seed(0), "cpu", arch="big_lama")
    assert G.sizes == BIG_LAMA
    assert work_lama.parameters() == 50_882_177  # the convolutions' weights and biases
    convs = sum(p.numel() for k, p in G.named_parameters() if ".bn" not in k
                and not k.endswith((".conv1.1.weight", ".conv1.1.bias"))
                and k.split(".")[1] not in ("25", "28", "31"))  # the up path's BatchNorms
    assert convs == work_lama.parameters()
    assert sizes_from_state(G.state_dict()) == BIG_LAMA
    block = G.model[5].conv1
    assert (block.bn_l.num_features, block.bn_g.num_features) == (128, 384)


def test_a_gan_step_matches_the_train_reference(state):
    d_state = seeded_state("discriminator", 8, 12, CPU)
    v_state = seeded_state("vgg", 0, 13, CPU)
    G = port(state, True)
    D = Discriminator(8)
    D.load_state_dict(d_state)
    vgg = VGG16Features()
    vgg.load_state_dict(v_state)
    gan = GANTrainState.create(G, D, lr=2e-4)
    grads = {}
    for n, mod in (("generator", G), ("discriminator", D)):
        for k, p in mod.named_parameters():
            p.register_post_accumulate_grad_hook(
                lambda p, n=n, k=k: grads.setdefault(n, {}).__setitem__(k, p.grad.clone()))
    w = {"perceptual": 0.1, "tv": 0.1, "boundary": 0.5}
    b = batch(6)
    metrics = make_train_step()(gan, b, vgg)
    ref = reference.LamaTrainReference(state, v_state, w, 2e-4, d_state)
    want = ref.step(b)
    # losses: sums over the batch's pixels of fp32 values
    assert compare.loss_gap([float(metrics["g_loss"]), float(metrics["d_loss"])], want) < 1e-6
    for n, mod in (("generator", G), ("discriminator", D)):
        got = compare.norms(grads[n])
        ref_grads = compare.norms(ref.grads[n])
        # the gradient's round-off, relative to the median leaf (TF32 reads 5e-2 here)
        assert compare.leaf_gap(got, ref_grads) < 1e-5, n
        moved = compare.norms({k: p.detach() - (state if n == "generator" else d_state)[k]
                               for k, p in mod.named_parameters()})
        ref_moved = compare.norms({k: ref.params(n)[k].detach()
                                   - (state if n == "generator" else d_state)[k]
                                   for k in ref_grads})
        # Adam's first update moves every element by about the rate, so round-off
        # in a small gradient's sign shows: 1e-4 (TF32 reads 5e-2)
        assert compare.leaf_gap(moved, ref_moved, compare.moving_leaves(ref_grads)) < 1e-4, n


def tiny_big_lama(monkeypatch):
    """``init_generator``'s Big-LaMa cut to ``SIZES``' 2 blocks (``ngf`` is its width argument)."""
    monkeypatch.setattr(weights, "BIG_LAMA", {**BIG_LAMA, "n_blocks": SIZES["n_blocks"]})


def test_checkpoints_record_and_load_either_generator(tmp_path, monkeypatch):
    tiny_big_lama(monkeypatch)
    g = torch.Generator().manual_seed(1)
    G = init_generator(8, g, "cpu", arch="big_lama")
    gan = GANTrainState.create(G, Discriminator(8))
    export_pth(tmp_path / "master.pth", gan)
    master = torch.load(tmp_path / "master.pth", weights_only=True)
    assert master["architecture"] == "big_lama"
    sd = G.state_dict()
    torch.save({"model_state_dict": sd}, tmp_path / "hg.pth")
    torch.save(sd, tmp_path / "raw.pth")
    for name in ("master.pth", "hg.pth", "raw.pth"):
        back = load_generator(tmp_path / name, "cpu")
        assert isinstance(back, FFCResNetGenerator) and not back.training
        assert back.sizes == {**SIZES, "ngf": 8}
        assert all(torch.equal(v, back.state_dict()[k]) for k, v in sd.items())
    pconv = GANTrainState.create(init_generator(8, g, "cpu"), Discriminator(8))
    export_pth(tmp_path / "pconv.pth", pconv)
    assert torch.load(tmp_path / "pconv.pth", weights_only=True)["architecture"] == "pconv_unet"
    with pytest.raises(ValueError, match="unknown generator"):
        init_generator(8, g, "cpu", arch="unet")


def test_model_generator_in_the_config(caplog):
    assert Config().model.generator == "pconv_unet"
    assert Config.from_dict({"model": {"generator": "big_lama"}}).model.generator == "big_lama"
    with caplog.at_level(logging.WARNING, "terra_gan_tpu_torch.config"):
        Config.from_dict({"model": {"generater": "big_lama"}})
    assert any("model.generater" in r.message and "'generator'" in r.message
               for r in caplog.records)
    with pytest.raises(ValueError, match="model.generator"):
        Config.from_dict({"model": {"generator": "lama"}})


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


def test_cli_trains_evaluates_and_fine_tunes_a_tiny_lama(tmp_path, monkeypatch, root_logging):
    from PIL import Image
    from test_torch_train_mode import CONFIG, workspace

    config = CONFIG.replace("training:\n", "model:\n  generator: big_lama\ntraining:\n")
    config = config.replace("      epochs: 2\n", "      epochs: 1\n")
    monkeypatch.chdir(workspace(tmp_path, config))
    monkeypatch.setenv("EXPERIMENT_MODE", "true")
    full = weights.init_generator
    # the published Big-LaMa holds 51 M parameters: a tiny one here
    tiny_big_lama(monkeypatch)
    monkeypatch.setattr(weights, "init_generator",
                        lambda w, g, device, arch: full(8, g, device, arch=arch))

    def cli(mode, *args):
        return main_pipeline.main(["--mode", mode, "--device", "cpu", *args])

    assert cli("train") == 0
    master = torch.load("ckpts/master_checkpoint.pth", weights_only=True)
    assert master["architecture"] == "big_lama"
    assert sizes_from_state(master["generator_state_dict"]) == SIZES
    assert cli("evaluate") == 0
    tests = sorted(Path("data/processed/NJ00/test/images").glob("*.png"))
    written = sorted(Path("data/output").rglob("*_inpainted.png"))
    assert len(tests) == 3 and len(written) == 3
    hdir = Path("data/output/NJ00/human_annotation_masks")
    hdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for p in tests:
        human = ((rng.random((HW, HW)) > 0.8) * 255).astype(np.uint8)
        Image.fromarray(human).save(hdir / f"NJ00_colored_{p.stem}_u1a2_mask.png")
    before = master["generator_state_dict"]
    assert cli("human_guided_train", "--grid", "NJ00") == 0
    tuned = torch.load("ckpts/master_checkpoint.pth", weights_only=True)
    assert tuned["human_guided"] is True and tuned["architecture"] == "big_lama"
    assert set(tuned["generator_state_dict"]) == set(before)
    assert any(not torch.equal(v, before[k]) for k, v in tuned["generator_state_dict"].items())


def test_a_small_lama_cell_under_profile_steps():
    import argparse
    import importlib.util
    import time

    spec = importlib.util.spec_from_file_location(
        "profile_steps", Path(__file__).resolve().parents[1] / "profile_steps.py")
    ps = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ps)
    args = argparse.Namespace(workload="lama.train-b16", seed=2**31 + 9, seconds=1.0, trace=0)
    small = {"config": {**SIZES, "ratio_gin": 0.75, "ratio_gout": 0.75, "image_size": HW,
                        "discriminator_width": 8, "batch_size": {"gan": 4}},
             "traffic": {"tiles": 15}}
    rep = ps.profile_cell(args, time.perf_counter(), torch.device("cpu"), small)
    steps = rep["counts"]["steps"]
    assert rep["correct"] and steps >= 3
    for name in ("tg.lama_down", "tg.lama_up", "tg.g_forward"):
        assert rep["ranges"][name] == steps
    assert rep["ranges"]["tg.ffc_spectral"] == rep["ranges"]["tg.ffc_local"] == 4 * steps
    assert rep["per_step"]["spectral_calls"] == 2 * SIZES["n_blocks"]  # one G forward a step
    assert rep["per_step"]["ffc_local_launches"] == 0  # the plain version on the CPU: no launch
    assert set(rep["per_step"]["lama_forward_ms"]) == set(ps.LAMA_RANGES)
