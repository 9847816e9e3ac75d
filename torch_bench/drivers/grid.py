"""Grid inpainting: one parent grid's tiles fed again and again through
``BatchedInpainter.stream_from`` at the mix's chunk, uint8 back.

Set-up: seeded weights loaded into the program's ``PConvUNet``, the grid's
tiles, one warm pass of every chunk size a pass uses. Window: passes over
the grid until the time is up; tiles counted as they come back to the
host. Check: chunks sampled from the seed keep their uint8 answers and,
by a hook on the model's dec2 stage, their dec2 features; after the
window the reference recomputes both.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from torch_bench import compare, traffic
from torch_bench.reference.steps import eval_forward, precision
from torch_bench.weights import seeded_state


def chunk_bounds(n: int, chunk: int):
    return [(s, min(s + chunk, n)) for s in range(0, n, chunk)]


def break_path(inp, fault: str) -> None:
    """Faults the check has to catch, planted under the timed path."""
    forward = inp._forward
    if fault == "answer":  # one tile of every chunk altered where it is produced
        def altered(images, masks):
            out = forward(images, masks).clone()
            out[0] ^= 1
            return out
        inp._forward = altered
    elif fault == "half_batch":  # half of each chunk computed, the rest copies
        def halved(images, masks):
            h = max(1, images.shape[0] // 2)
            out = forward(images[:h], masks[:h])
            return torch.cat([out, out[: images.shape[0] - h]])
        inp._forward = halved
    else:
        raise ValueError(f"no fault {fault!r} in this driver")


def run(run) -> None:
    from terra_gan_tpu_torch.models.generator import PConvUNet
    from terra_gan_tpu_torch.parallel.infer import BatchedInpainter

    cfg, mix, dev = run.config, run.traffic, run.device
    side, width, chunk = cfg["image_size"], cfg["base_width"], mix["chunk"]
    images, masks = traffic.tile_set(mix, mix["tiles"], side, run.seed, dev)
    bounds = chunk_bounds(len(images), chunk)
    state = seeded_state("generator", width, run.seed, dev)
    if run.control:
        from torch_bench.drivers.control import reference_program
        model = reference_program(state, run.control)
    else:
        model = PConvUNet(width)
        model.load_state_dict(state)
    del state
    inp = BatchedInpainter(model, dev, chunk=chunk, quantize_uint8=True)
    if run.fault:
        break_path(inp, run.fault)

    for size in sorted({e - s for s, e in bounds}, reverse=True):
        for _ in range(2):
            inp(images[:size], masks[:size])

    # the sample: chunk i is kept where draw[i] < share, at most `keep`
    draws = np.random.default_rng([run.seed % 2**63, 7]).random(mix["max_chunks"])
    share, keep = mix["sample_share"], mix["sample_chunks"]
    kept_feats, kept_out = {}, {}
    current = [-1]

    def tap(module, args, out):
        i = current[0]
        if 0 <= i < len(draws) and draws[i] < share and len(kept_feats) < keep:
            kept_feats[i] = out[0].detach().clone()

    hook = model.dec2.register_forward_hook(tap)
    if run.tracing:  # spans around the program's upload-and-dispatch and its wait
        for name, label in (("_dispatch", "dispatch"), ("_finish", "wait")):
            method = getattr(inp, name, None)
            if method is not None:
                setattr(inp, name, lambda *a, _m=method, _l=label: _span_call(run, _l, _m, a))

    batches = []
    with run.window() as t0:
        end = t0 + run.seconds

        def feed():
            i = 0
            while time.perf_counter() < end:
                s, e = bounds[i % len(bounds)]
                current[0] = i
                yield i, images[s:e], masks[s:e]
                i += 1

        for i, out in inp.stream_from(feed()):
            batches.append(len(out))
            if i in kept_feats:
                kept_out[i] = out.copy()
    hook.remove()
    run.counts.update(tiles=sum(batches), forward_batches=batches)
    run.attempted, run.failed = sum(batches), 0
    del inp, model
    run.free()

    feat_errs, diff, total = [], 0, 0
    state = seeded_state("generator", width, run.seed, dev)
    with precision("fp32", dev):
        for i in sorted(kept_out):
            s, e = bounds[i % len(bounds)]
            want_u8, want_feat = eval_forward(
                state, torch.from_numpy(images[s:e]).to(dev),
                torch.from_numpy(masks[s:e]).to(dev))
            feat_errs.append(compare.nrmse(kept_feats.pop(i), want_feat))
            got = torch.from_numpy(kept_out[i]).to(dev)
            diff += int((got != want_u8).sum()) if got.shape == want_u8.shape else got.numel()
            total += want_u8.numel()
    run.info("sampled_chunks", len(kept_out))
    run.check("dec2_nrmse", compare.worst(feat_errs), run.limits["dec2_nrmse"])
    run.check("u8_mismatch", diff / total if total else float("inf"), run.limits["u8_mismatch"])


def _span_call(run, label, method, args):
    with run.span(label):
        return method(*args)

