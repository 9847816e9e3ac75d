"""Training: the loop body of ``training/loop.py:train`` (mix ``step`` "gan")
or of ``HumanGuidedTrainer.train`` ("hg"), driven over seeded PNG tiles.

Set-up: the tiles written as PNGs, the program's dataset and
``BatchLoader`` (shuffled from the seed, the partial last batch kept,
the port's default feed threads and tile cache), the models with seeded
weights and their Adams, then the first epoch's steps through the same
loader, ``_to_device`` and step call as the window's: they warm every
batch shape and Adam's first and later steps. Then the models and the
optimizers are set back to their seeded state, so the window drives the
same objects from the seed. Window: steps until the time is up (at
least ``compare_steps``), then a device sync; every sample of every
step counts. Its first ``compare_steps`` steps are the ones the
reference follows (the second epoch's batches): their losses, each
leaf's gradient in the first of them as backward leaves it for the
optimizer (a post-accumulate hook), and each leaf's change after them.
"""

from __future__ import annotations

import copy
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
from PIL import Image

from torch_bench import compare, traffic
from torch_bench.reference.steps import TrainReference, precision
from torch_bench.weights import seeded_state


@dataclass
class Trained:
    """One trained model of a step: every tensor its state holds (parameters
    and buffers, set back after the warm-up), the trainable leaves by
    name, and its optimizer."""

    state: Dict[str, torch.Tensor]
    leaves: Dict[str, torch.Tensor]
    opt: torch.optim.Optimizer


def write_png(path: Path, u8: np.ndarray) -> None:
    Image.fromarray(np.ascontiguousarray(u8[..., 0])).save(path, compress_level=1)


def make_data(run, root: Path):
    """The tiles as PNG files and the program's dataset over them; also the
    arrays, for the reference."""
    from terra_gan_tpu_torch.data.dataset import DirectMatchDataset, InpaintingDataset

    mix, side = run.traffic, run.config["image_size"]
    hg = mix["step"] == "hg"
    n = int(round(mix["tiles"] * mix.get("split", 1.0)))
    tiles = traffic.tile_set(mix, n, side, run.seed, run.device, human=hg)
    arrays = dict(zip(("image", "mask", "human_mask"), tiles))
    images, masks = arrays["image"], arrays["mask"]
    for sub in ("images", "masks", "human"):
        (root / sub).mkdir()
    for i in range(n):
        write_png(root / "images" / f"tile_{i:04d}.png", images[i])
        write_png(root / "masks" / f"tile_{i:04d}.png", masks[i])
    if not hg:
        return InpaintingDataset(root / "images", root / "masks", size=side), arrays
    human = arrays["human_mask"]
    pairs = []
    for i in range(n):
        write_png(root / "human" / f"tile_{i:04d}.png", human[i])
        pairs.append({"tile_name": f"tile_{i:04d}", "image_path": root / "images" / f"tile_{i:04d}.png",
                      "system_mask_path": root / "masks" / f"tile_{i:04d}.png",
                      "human_mask_path": root / "human" / f"tile_{i:04d}.png"})
    return DirectMatchDataset(pairs, size=side), arrays


def reference_batches(arrays: Dict[str, np.ndarray], batch: int, seed: int, skip: int,
                      steps: int):
    """The loader's batches ``skip`` to ``skip + steps`` (one permutation per
    epoch from ``np.random.default_rng(seed)``, the partial last batch
    kept), decoded as the datasets decode them: images u8 / 255 in
    float32, masks > 0."""
    rng, n, out = np.random.default_rng(seed), len(arrays["image"]), []
    while len(out) < skip + steps:
        order = np.arange(n)
        rng.shuffle(order)
        for s in range(0, n, batch):
            idx = order[s : s + batch]
            b = {"image": arrays["image"][idx].astype(np.float32) / 255.0}
            for k in ("mask", "human_mask"):
                if k in arrays:
                    b[k] = (arrays[k][idx] > 0).astype(np.float32)
            out.append(b)
    return out[skip : skip + steps]


def build_program(run, states):
    """(step(batch) -> losses, {model name: Trained}): the port's, or with
    ``run.control`` the reference's in the control's precision."""
    from terra_gan_tpu_torch.config import Config, LoopConfig
    from terra_gan_tpu_torch.models.discriminator import Discriminator
    from terra_gan_tpu_torch.models.generator import PConvUNet
    from terra_gan_tpu_torch.models.vgg import VGG16Features
    from terra_gan_tpu_torch.training.human_guided import HumanGuidedTrainer
    from terra_gan_tpu_torch.training.state import GANTrainState, adam
    from terra_gan_tpu_torch.training.step import make_train_step

    cfg, dev, mode = run.config, run.device, run.traffic["step"]
    w = cfg["loss_weights"]
    if run.control:
        ref = TrainReference(mode, states["generator"], states["vgg"], w,
                             cfg["learning_rate"][mode], states.get("discriminator"))

        def step(batch):
            with precision(run.control, dev):
                return ref.step(batch)

        return step, {n: Trained(ref.params(n), {k: v for k, v in ref.params(n).items()
                                                 if v.requires_grad}, opt)
                      for n, opt in (("generator", ref.g_opt), ("discriminator", ref.d_opt))
                      if opt is not None}

    def trained(module, opt):
        return Trained(module.state_dict(), {k: p for k, p in module.named_parameters()
                                             if p.requires_grad}, opt)

    G = PConvUNet(cfg["base_width"])
    G.load_state_dict(states["generator"])
    vgg = VGG16Features()
    vgg.load_state_dict(states["vgg"])
    G, vgg = G.to(dev), vgg.to(dev)
    if mode == "gan":
        D = Discriminator(cfg["discriminator_width"])
        D.load_state_dict(states["discriminator"])
        loop = LoopConfig(batch_size=cfg["batch_size"]["gan"], learning_rate=cfg["learning_rate"]["gan"],
                          perceptual=w["perceptual"], tv=w["tv"], boundary=w["boundary"])
        state = GANTrainState.create(G, D.to(dev), lr=loop.learning_rate)
        step_fn = make_train_step(loop.loss_config())

        def step(batch):
            m = step_fn(state, batch, vgg)
            return [m["g_loss"], m["d_loss"]]

        return step, {"generator": trained(G, state.g_opt),
                      "discriminator": trained(state.discriminator, state.d_opt)}
    trainer = HumanGuidedTrainer(Config())
    lc = trainer.loss_config
    if (lc.base.perceptual_weight, lc.base.tv_weight, lc.base.boundary_weight,
            lc.base_loss_weight, lc.human_feedback_weight) != (
            w["perceptual"], w["tv"], w["boundary"], w["base_loss_weight"], w["human_feedback_weight"]):
        raise RuntimeError(f"the port's human-guided loss weights {lc} are not the config's {w}")
    opt = adam(G.parameters(), cfg["learning_rate"]["hg"])
    step_fn = trainer.make_step(G, opt)

    def step(batch):
        return [step_fn(batch, vgg)[0]]

    return step, {"generator": trained(G, opt)}


def break_step(step, models, fault: str):
    """Faults the check has to catch, planted under the timed path."""
    if fault == "unchanged":  # a step that leaves the state as it was
        for m in models.values():
            m.opt.step = lambda *a, **k: None
        return step
    if fault == "half_batch":  # half of each batch, the mean over the rest
        return lambda batch: step({k: v[: max(1, len(v) // 2)] for k, v in batch.items()})
    raise ValueError(f"no fault {fault!r} in this driver")


def snapshot(models: Dict[str, Trained]):
    """What ``restore`` sets the models and their optimizers back to."""
    return {n: ({k: t.detach().clone() for k, t in m.state.items()},
                copy.deepcopy(m.opt.state_dict())) for n, m in models.items()}


@torch.no_grad()
def restore(models: Dict[str, Trained], saved) -> None:
    for n, m in models.items():
        tensors, opt_state = saved[n]
        for k, t in m.state.items():
            t.copy_(tensors[k])
        m.opt.load_state_dict(opt_state)


def record_grads(models: Dict[str, Trained], into: Dict[str, Dict[str, torch.Tensor]]) -> List:
    """Hooks that keep each leaf's gradient norm (on the device) as backward
    leaves it; a leaf that gets two, as D's does in the G step and in its
    own, keeps the last, which its optimizer takes."""
    def hook(n, k):
        def keep(p):
            into[n][k] = p.grad.detach().double().norm()
        return keep

    return [p.register_post_accumulate_grad_hook(hook(n, k))
            for n, m in models.items() for k, p in m.leaves.items()]


def floats(norms: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Dict[str, float]]:
    return {n: {k: float(v) for k, v in leaves.items()} for n, leaves in norms.items()}


def run(run) -> None:
    from terra_gan_tpu_torch.data.dataset import BatchLoader
    from terra_gan_tpu_torch.training.loop import _to_device

    cfg, mix, dev = run.config, run.traffic, run.device
    mode = mix["step"]
    batch = cfg["batch_size"][mode]
    names = ["generator", "vgg"] + (["discriminator"] if mode == "gan" else [])
    widths = {"generator": cfg["base_width"], "vgg": 0,
              "discriminator": cfg.get("discriminator_width", 0)}
    loader_seed = run.seed % 2**63
    with tempfile.TemporaryDirectory(prefix="torch_bench_") as tmp:
        dataset, arrays = make_data(run, Path(tmp))
        loader = BatchLoader(dataset, batch, shuffle=True, seed=loader_seed, drop_last=False)

        def stream():
            while True:
                yield from loader

        feed = stream()
        step, models = build_program(run, {n: seeded_state(n, widths[n], run.seed, dev)
                                           for n in names})
        if run.fault:
            step = break_step(step, models, run.fault)
        warm, compare_steps = len(loader), mix["compare_steps"]
        seeded = snapshot(models)
        for _ in range(warm):  # one epoch: every batch shape, Adam's first and later steps
            step(_to_device(next(feed), dev))
        restore(models, seeded)
        start = {n: {k: t for k, t in seeded[n][0].items() if k in m.leaves}
                 for n, m in models.items()}
        del seeded
        grads: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in models}
        hooks = record_grads(models, grads)
        losses, deltas = [], {}

        samples, steps = 0, 0
        with run.window() as t0:
            end = t0 + run.seconds
            while steps < compare_steps or time.perf_counter() < end:
                with run.span("loader"):
                    b = next(feed)
                with run.span("upload"):
                    db = _to_device(b, dev)
                with run.span("step"):
                    out = step(db)
                samples += len(b["image"])
                steps += 1
                if steps <= compare_steps:  # the steps the reference follows
                    losses.append(out)
                    if steps == 1:
                        for h in hooks:
                            h.remove()
                    if steps == compare_steps:
                        deltas = {n: {k: (p.detach() - start[n][k]).double().norm()
                                      for k, p in m.leaves.items()} for n, m in models.items()}
                        del start
        feed.close()
        run.counts.update(samples=samples, steps=steps, batch=batch)
        run.attempted, run.failed = steps, 0
        losses = [[float(v) for v in step_losses] for step_losses in losses]
        first_grads, deltas = floats(grads), floats(deltas)
        del feed, loader, dataset, step, models, hooks, grads, db, b, out
        run.free()

    states = {n: seeded_state(n, widths[n], run.seed, dev) for n in names}
    w = dict(cfg["loss_weights"])
    with precision("fp32", dev):
        ref = TrainReference(mode, states["generator"], states["vgg"], w,
                             cfg["learning_rate"][mode], states.get("discriminator"))
        ref_losses = []
        for b in reference_batches(arrays, batch, loader_seed, warm, compare_steps):
            ref_losses.append(ref.step({k: torch.from_numpy(v).to(dev) for k, v in b.items()}))
    ref_grads = {n: compare.norms(g) for n, g in ref.grads.items()}
    ref_deltas = {n: compare.norms({k: ref.params(n)[k].detach() - states[n][k]
                                    for k in ref_grads[n]}) for n in ref_grads}
    # the first step's losses: later steps' carry Adam's first update, which
    # moves every element by about the rate whatever its gradient, so
    # elements whose gradient is round-off move by a random sign
    for i, (got, want) in enumerate(zip(losses, ref_losses)):
        run.info(f"loss_gap.step{i + 1}", compare.loss_gap(got, want))
    run.check("loss_gap", compare.loss_gap(losses[0], ref_losses[0]), run.limits["loss_gap"])
    for n in ref_grads:  # where the worst leaves are
        for label, gaps in (("grad_gap", compare.leaf_gaps(first_grads[n], ref_grads[n])),
                            ("update_gap", compare.leaf_gaps(
                                deltas[n], ref_deltas[n], compare.moving_leaves(ref_grads[n])))):
            top = sorted(gaps.items(), key=lambda kv: -kv[1] if kv[1] == kv[1] else -1e300)[:3]
            run.info(f"{label}.{n}.worst", " ".join(f"{k}={v:.3g}" for k, v in top))
            run.info(f"{label}.{n}.median", float(np.median(list(gaps.values()))))
    run.check("grad_gap", compare.worst(compare.leaf_gap(first_grads[n], ref_grads[n])
                                        for n in ref_grads), run.limits["grad_gap"])
    run.check("update_gap", compare.worst(compare.leaf_gap(deltas[n], ref_deltas[n],
                                                           compare.moving_leaves(ref_grads[n]))
                                          for n in ref_grads), run.limits["update_gap"])
