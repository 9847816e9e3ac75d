"""Training with DeepFill v2's generator: ``training/loop.py:train``'s loop
body (``make_train_step``: the G step with its coarse term, and the D
step) with a ``DeepFillV2Generator`` as G, driven over seeded PNG tiles.

As ``drivers/lama_train.py`` runs Big-LaMa's cell: set-up writes the
tiles, builds the program's ``InpaintingDataset`` and ``BatchLoader``
(shuffled from the seed, the partial last batch kept, the port's feed
threads and tile cache), the models with seeded weights and their Adams,
and runs the first epoch through the same loader, ``_to_device`` and
step as the window; then the models and optimizers are set back to
their seeded state. Window: steps until the time is up (at least
``compare_steps``), then a device sync. Its first ``compare_steps``
steps are the ones ``reference/deepfill.py``'s ``DeepFillTrainReference``
follows: the first one's losses and each leaf's gradient, each leaf's
change after the last.

In a traced run on a card, after the window and before the program is
freed, three more steps run under a profiler of their own: the device
time launched inside ``tg.ctx_attn`` a step goes to
``run.counts["ctx_attn_device_ms"]`` and the mean batch of those steps
to ``run.counts["ctx_attn_batch"]`` (``phases.PhaseTrace``).
"""

from __future__ import annotations

import math
import tempfile
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from torch_bench import compare
from torch_bench.drivers.lama_train import range_device_ms
from torch_bench.drivers.train import (
    Trained,
    break_step,
    floats,
    make_data,
    record_grads,
    reference_batches,
    restore,
    snapshot,
)
from torch_bench.reference import deepfill as reference
from torch_bench.weights import seeded_state

CTX_ATTN = "tg.ctx_attn"


def seeded_generator(cnum: int, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The generator's state dict drawn from ``seed`` by the rules of
    ``torch_bench/weights.py`` (he, uniform), on the stream weights.py
    gives a generator."""
    spec = reference.generator_spec(cnum)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 4) % 2**63)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (key, shape, rule), n in zip(spec, sizes):
        z, u = normal[at : at + n].view(shape), uniform[at : at + n].view(shape)
        at += n
        if rule[0] == "he":
            out[key] = (z * math.sqrt(2.0 / rule[1])).clone()
        elif rule[0] == "uniform":
            out[key] = ((2.0 * u - 1.0) * rule[1]).clone()
        else:
            raise ValueError(f"unknown init rule {rule}")
    return out


def seeded_states(run) -> Dict[str, Dict[str, torch.Tensor]]:
    cfg, dev = run.config, run.device
    return {"generator": seeded_generator(cfg["cnum"], run.seed, dev),
            "discriminator": seeded_state("discriminator", cfg["discriminator_width"], run.seed,
                                          dev),
            "vgg": seeded_state("vgg", 0, run.seed, dev)}


def build_program(run, states):
    """(step(batch) -> [g_loss, d_loss], {model name: Trained}): the port's,
    or with ``run.control`` the reference's in the control's precision."""
    from terra_gan_tpu_torch.config import LoopConfig
    from terra_gan_tpu_torch.models.deepfill import DeepFillV2Generator
    from terra_gan_tpu_torch.models.discriminator import Discriminator
    from terra_gan_tpu_torch.models.vgg import VGG16Features
    from terra_gan_tpu_torch.training.state import GANTrainState
    from terra_gan_tpu_torch.training.step import make_train_step

    cfg, dev = run.config, run.device
    w, lr = cfg["loss_weights"], cfg["learning_rate"]["gan"]
    if run.control:
        ref = reference.DeepFillTrainReference(states["generator"], states["vgg"], w, lr,
                                               states["discriminator"])

        def step(batch):
            with reference.precision(run.control, dev):
                return ref.step(batch)

        return step, {n: Trained(ref.params(n), {k: v for k, v in ref.params(n).items()
                                                 if v.requires_grad}, opt)
                      for n, opt in (("generator", ref.g_opt), ("discriminator", ref.d_opt))}

    G = DeepFillV2Generator(cfg["cnum"])
    G.load_state_dict(states["generator"])
    D = Discriminator(cfg["discriminator_width"])
    D.load_state_dict(states["discriminator"])
    vgg = VGG16Features()
    vgg.load_state_dict(states["vgg"])
    vgg = vgg.to(dev)
    loop = LoopConfig(batch_size=cfg["batch_size"]["gan"], learning_rate=lr,
                      perceptual=w["perceptual"], tv=w["tv"], boundary=w["boundary"])
    state = GANTrainState.create(G.to(dev), D.to(dev), lr=lr)
    step_fn = make_train_step(loop.loss_config())

    def step(batch):
        m = step_fn(state, batch, vgg)
        return [m["g_loss"], m["d_loss"]]

    def trained(module, opt):
        return Trained(module.state_dict(), {k: p for k, p in module.named_parameters()
                                             if p.requires_grad}, opt)

    return step, {"generator": trained(state.generator, state.g_opt),
                  "discriminator": trained(state.discriminator, state.d_opt)}


def run(run) -> None:
    # the program's DeepFill first: a program without it fails here, at once
    from terra_gan_tpu_torch.models.deepfill import DeepFillV2Generator  # noqa: F401
    from terra_gan_tpu_torch.data.dataset import BatchLoader
    from terra_gan_tpu_torch.training.loop import _to_device

    cfg, mix, dev = run.config, run.traffic, run.device
    if mix["step"] != "gan":
        raise ValueError("deepfill_train drives the GAN step alone")
    batch = cfg["batch_size"]["gan"]
    loader_seed = run.seed % 2**63
    with tempfile.TemporaryDirectory(prefix="torch_bench_") as tmp:
        dataset, arrays = make_data(run, Path(tmp))
        loader = BatchLoader(dataset, batch, shuffle=True, seed=loader_seed, drop_last=False)

        def stream():
            while True:
                yield from loader

        feed = stream()
        step, models = build_program(run, seeded_states(run))
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
        if run.tracing and dev.type == "cuda":
            profiled = []

            def next_batch():
                b = next(feed)
                profiled.append(len(b["image"]))
                return _to_device(b, dev)

            run.counts["ctx_attn_device_ms"] = range_device_ms(run, step, next_batch, CTX_ATTN)
            run.counts["ctx_attn_batch"] = sum(profiled) / len(profiled)
        feed.close()
        run.counts.update(samples=samples, steps=steps, batch=batch)
        run.attempted, run.failed = steps, 0
        losses = [[float(v) for v in step_losses] for step_losses in losses]
        first_grads, deltas = floats(grads), floats(deltas)
        del feed, loader, dataset, step, models, hooks, grads, db, b, out
        run.free()

    states = seeded_states(run)
    with reference.precision("fp32", dev):
        ref = reference.DeepFillTrainReference(states["generator"], states["vgg"],
                                               dict(cfg["loss_weights"]),
                                               cfg["learning_rate"]["gan"],
                                               states["discriminator"])
        ref_losses = []
        for b in reference_batches(arrays, batch, loader_seed, warm, compare_steps):
            ref_losses.append(ref.step({k: torch.from_numpy(v).to(dev) for k, v in b.items()}))
    ref_grads = {n: compare.norms(g) for n, g in ref.grads.items()}
    ref_deltas = {n: compare.norms({k: ref.params(n)[k].detach() - states[n][k]
                                    for k in ref_grads[n]}) for n in ref_grads}
    # the first step's losses: later steps' carry Adam's first update, which
    # moves every element by about the rate whatever its gradient
    for i, (got, want) in enumerate(zip(losses, ref_losses)):
        run.info(f"loss_gap.step{i + 1}", compare.loss_gap(got, want))
    run.check("loss_gap", compare.loss_gap(losses[0], ref_losses[0]), run.limits["loss_gap"])
    moving = {n: compare.moving_leaves(ref_grads[n]) for n in ref_grads}
    for n in ref_grads:  # where the worst leaves are
        for label, gaps in (("grad_gap", compare.leaf_gaps(first_grads[n], ref_grads[n])),
                            ("update_gap", compare.leaf_gaps(deltas[n], ref_deltas[n],
                                                             moving[n]))):
            top = sorted(gaps.items(), key=lambda kv: -kv[1] if kv[1] == kv[1] else -1e300)[:3]
            run.info(f"{label}.{n}.worst", " ".join(f"{k}={v:.3g}" for k, v in top))
            run.info(f"{label}.{n}.median", float(np.median(list(gaps.values()))))
    run.check("grad_gap", compare.worst(compare.leaf_gap(first_grads[n], ref_grads[n])
                                        for n in ref_grads), run.limits["grad_gap"])
    run.check("update_gap", compare.worst(compare.leaf_gap(deltas[n], ref_deltas[n], moving[n])
                                          for n in ref_grads), run.limits["update_gap"])
