"""Where the time goes in the PyTorch port's 512^2 inference, serving and training slices, on one CUDA card.

    python3 profile_slice.py [--out chiprun_out/profile_slice.json]

The full-width PConvUNet with seeded random weights, TF32 off and cuDNN
benchmark on, as in chip_smoke.py (whose helpers it uses). The inference
leg measures

  1. the forward alone, kernel path (its tail K3, and for comparison
     the unfused tail) and plain path, tiles/s at batch 1, 8, 16 and 32
     (CUDA events, median of 5 after 2 warm-up calls);
  2. end to end, uint8 in and out through BatchedInpainter, 32 DSM-like
     tiles at chunk 8, 16 and 32, two runs each (host clock);
  3. a torch.profiler trace of the end-to-end run at chunk 8: device
     busy time (union of the device events), the idle share of the
     host's window, and device time by kernel name;
  4. K2 at each of the 14 stages at batch 1 and 8 (chip_smoke.k2_stage):
     its variant, tile and split count, kernel, plain and library ms
     (one cuDNN fp32 conv of the same masked input, channels_last), the
     TFLOP/s of each, the bound at the unit's peak, the wrapper's host
     time a call; the packing of the weight into K2's TF32 planes,
     timed alone, plain and by the pack kernel; and, for
     the MMA stages, the planned kernel, the kernel on the other tile
     and, where the plan splits K, unsplit, each through the C entry
     called directly (the reasons for plan_stage's choices); then enc1
     at batch 1, 2, 8 and 32 by CUDA graph replay (chip_smoke.enc1_times:
     one kernel node a call, inputs rotated past the L2) beside its plain
     version, cuDNN's conv alone, the SIMT kernel, the empty launch and
     its bound, and with --parent DIR the parent's enc1 (its SIMT kernel, built alone from DIR's
     csrc/pconv_eval.cu, HWIO weights) in turns parent, change, change,
     parent;
  5. the tail per call at batch 1, 8, 16 and 32 on the model's own dec2
     outputs: K3 (the model's eval tail), its plain version and the
     unfused kernel path it replaces (K1, K2's dec1, cuDNN's final conv,
     the composite), ms and K3's TFLOP/s beside its bound (dec1 at the
     3xTF32 rate, the final conv at fp32's).
The inference leg also times the forward's one pack of K2's weight
planes (all 14 stages, ``PConvUNet.packed_weights``).

The serving leg starts the port's server (max_batch 16, the JAX
default) in a thread on 127.0.0.1 and drives it through the port's
client:

  6. requests/s and client p50/p95 latency at concurrency 1 (16
     requests) and 16 (64 requests), with the mean batch the batcher
     formed;
  7. a torch.profiler trace of 32 requests at concurrency 16: busy
     time, idle share, device time by kernel name and K3's share.

The train leg (G, D and VGG seeded, the full loss, one batch already on
the card) measures

  8. the train step at batch 8, 16 and 32: ms per step and samples/s
     over 5 steps after 2 warm-up steps, two runs each (host clock
     around synchronised steps), and the peak memory;
  9. a torch.profiler trace of 3 steps at batch 8: busy time, idle
     share, device time by kernel name and K1 backward's share.

The probes leg times P1-P5 (csrc/probes.cu) at scripts/probe_mosaic.py's
shapes, as chip_smoke.py's probes phase does (graph_device_ms: 1000
calls in one CUDA graph, the median of 5 timed replays over 1000):

 11. each variant of each (vec4, scalar), the library call for the same
     function (torch.matmul for P1 and P2, a * m[..., None] for P4; for
     P3, which has none, torch.matmul on the pre-built [a, 2a], the
     product alone; P5 has none) and an empty launch, and with --parent
     DIR (a checkout of the parent commit, e.g. unpacked by git archive
     into build/parent/) the parent's P5, built alone from DIR's
     csrc/probes.cu and called through its own C signature, in turns
     parent, change, change, parent; every version held against
     the plain version (P4 and P5 equal, P1-P3 within 1e-6 of max); then P3 at
     every tiling its C entry takes at that shape (rows and columns a
     block, K in one stage or in chunks of 32), through the C entry
     directly, beside the bytes its tiles copy into the busiest SM; and
     P3 as planned at K from 4 to 128 and M from 128 to 4096 (P3_SCALING).

The k1 leg times K1 fwd and bwd (csrc/upsample2x.cu) at the 7 decoder
shapes at batch 1, 2, 8 and 32, as chip_smoke.py's k1 phases do
(chip_smoke.k1_times: device ms a call by graph replay, one kernel node
a call, beside the plain version, the library call, an empty launch and
the byte bound, with the wrapper's host ms and the per-call ms):

 12. with --parent DIR the parent's two kernels, built alone from DIR's
     csrc/upsample2x.cu and called by the steps its wrappers took, in
     turns parent, change, change, parent, with the largest difference
     of their outputs from the change's; at batch 8, in fp32 and bf16,
     every tiling plan_upsample could pick (the adjoint's rows a thread,
     the tile height), through the C entry directly, each held
     bitwise to the wrapper's output. Every K1 timing rotates over copies of its input
     past the L2 (chip_smoke.past_l2).

The inference leg's trace also gives K1's share of busy time.

The turns leg (with --parent DIR) times the eval forward of the parent
checkout and of this one in turns, parent, change, change, parent, each
turn a process of its own started in its checkout (FORWARD_TURN: the
full-width model with seeded weights, DSM-like tiles, tiles/s at batch
1, 8 and 32 from the median of 10 calls by CUDA events after 3 warm-up
calls).

The epoch leg (with --parent DIR) times one train() run of the parent
checkout and of this one in turns, parent, change (one loader thread),
change with 4 (TERRA_GAN_TPU_FEED_WORKERS=4), the same again, change,
parent, each turn a process of its own started in its checkout
(EPOCH_TURN: the full-width models with seeded weights, 64 train and 8
validation DSM-like tiles as PNGs at batch 8, their masks at 512^2 and
again at 2000^2 as the ingest writes them, EPOCH_RUNS epochs with
cuDNN's benchmark off so that every turn runs the same convolutions; the
seconds of each epoch's train loop, loader included, from train()'s
history, the first epoch a warm-up).

The sass leg (with --parent DIR) builds the parent checkout's library
in its own tree (a process started there) and holds the SASS of K2's
(``pconv_``, ``pack_tf32``), K3's (``decoder_tail``) and the FFC
forward's (``ffc_local_kernel``) functions, instruction by instruction
(``cuobjdump -sass``: address, instruction, encoding), to this tree's:
a kernel whose source did not change compiles to the same code.

It prints one line per figure and writes all of them as JSON to --out
(and the traces beside it); --legs picks some of the legs (inference,
stage, tail, serve, train, probes, k1, turns, epoch, sass; all but
turns, epoch and sass by default).
Without CUDA it exits nonzero.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import re
import subprocess
import sys
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (
    K2_REL_TOL, SEED, SIZE, WIDTH, bound, dec2_outputs, device_batch, device_ms,
    dsm_tiles, enc1_times, graph_calls, graph_device_ms, host_ms, k1_line, k1_times, k2_stage,
    k3_bound, k3_work, line, ms_text, nbytes, past_l2, phase_build, phase_env, probe_check,
    rotating, simt_enc1, stage_geometries, stage_inputs, sum_bounds, time_ms, train_state,
    unfused_forward, upsample_shapes,
)
from terra_gan_tpu_torch.cli.probe_cuda import probe_inputs
from terra_gan_tpu_torch.ops.cuda._build import (
    BUILD_ROOT, NVCC_FLAGS, build_info, check, find_nvcc,
)
from terra_gan_tpu_torch.ops.cuda.probe_kernels import (
    CONCAT_ROWS, CONCAT_SMEM_BUDGET, CONCAT_THREADS, PLAIN, VARIANTS, concat_busiest_sm_bytes,
    concat_smem_bytes, empty_launch, plan_probe, probe_lane_concat_dot, probe_lane_reduce,
    probe_mask_broadcast, probe_matvec_dot, probe_row_build,
)
from terra_gan_tpu_torch.evaluation.inference import OUTPUT_SIZE
from terra_gan_tpu_torch.models.generator import STAGES
from terra_gan_tpu_torch.ops.cuda.tail_kernel import fused_decoder_tail, fused_decoder_tail_plain
from terra_gan_tpu_torch.ops.resize import upsample2x_bilinear
from terra_gan_tpu_torch.serving import InpaintClient, InpaintService, make_server
from terra_gan_tpu_torch.ops.cuda.upsample_kernel import (  # the tiling sweep takes the private two
    _launch_args, _tiling, plan_upsample, upsample2x_bwd, upsample2x_fwd,
)
from terra_gan_tpu_torch.training.step import make_train_step
from terra_gan_tpu_torch.ops.cuda._build import check, load_library
from terra_gan_tpu_torch.ops.cuda.pconv_kernel import (
    MMA_TILES,
    fused_pconv_eval,
    fused_pconv_eval_plain,
    pack_pconv_weight,
    pack_pconv_weights,
    plan_stage,
    sm_count,
)
from terra_gan_tpu_torch.parallel.infer import BatchedInpainter
from terra_gan_tpu_torch.utils.weights import init_generator

BATCHES = (1, 8, 16, 32)
TAIL_BATCHES = (1, 8, 16, 32)
SERVE_MAX_BATCH = 16
SERVE_LOADS = ((1, 16), (16, 64))  # (concurrency, requests)
CHUNKS = (8, 16, 32)
E2E_TILES = 32
STAGE_BATCHES = (1, 8)
ENC1_BATCHES = (1, 2, 8, 32)
K1_BATCHES = (1, 2, 8, 32)
SWEEP_BATCHES = (8,)  # where the k1 leg times every plan the planner could take
LEGS = ("inference", "stage", "tail", "serve", "train", "probes", "k1", "turns", "epoch", "sass")
DEFAULT_LEGS = LEGS[:-3]  # the turns, epoch and sass legs need --parent
# the functions the sass leg holds to the parent's: K2, K3 and the FFC forward
SASS_KEPT = re.compile(r"pconv_|pack_tf32|decoder_tail|ffc_local_kernel")
TURN_BATCHES = (1, 8, 32)
TRAIN_BATCHES = (8, 16, 32)
TRAIN_STEPS = 5
EPOCH_TILES, EPOCH_VAL, EPOCH_BATCH, EPOCH_RUNS = 64, 8, 8, 4
# the epoch leg's mask PNGs: at the tile's side, and at the RGB side the
# ingest writes them (the loader resizes them at every read)
EPOCH_MASK_PX = (SIZE, 2000)
TRACE_STEPS = 3


def forward_rates(model, dev, imgs, masks):
    rows = []
    for b in BATCHES:
        x = torch.from_numpy(imgs[:b].astype(np.float32) / 255.0).to(dev)
        m = torch.from_numpy((masks[:b] > 0).astype(np.float32)).to(dev)
        with torch.inference_mode():
            ms = time_ms(lambda: model(x * m, m), reps=5)
            unfused = time_ms(lambda: unfused_forward(model, x * m, m), reps=5)
            plain = time_ms(lambda: model.forward_plain(x * m, m), reps=5)
        row = dict(batch=b, ms=ms, unfused_tail_ms=unfused, plain_ms=plain,
                   tiles_per_s=1e3 * b / ms, unfused_tail_tiles_per_s=1e3 * b / unfused,
                   plain_tiles_per_s=1e3 * b / plain)
        line("forward", **{k: f"{v:.4f}" if isinstance(v, float) else v for k, v in row.items()})
        rows.append(row)
    with torch.inference_mode():  # the pack's call, its host time, and its device time
        pack = time_ms(model.packed_weights)
        pack_host, pack_dev = host_ms(model.packed_weights), device_ms(model.packed_weights)
    n = sum(getattr(model, s).input_conv.weight.numel() for s in STAGES)
    line("forward", pack_ms=f"{pack:.4f}", pack_host_ms=f"{pack_host:.4f}",
         pack_device_ms=ms_text(pack_dev, 4), weights=n, **bound(float(n), 12.0 * n))
    rows.append(dict(pack_ms=pack, pack_host_ms=pack_host, pack_device_ms=pack_dev, weights=n))
    return rows


def e2e_rates(model, dev, imgs, masks):
    rows = []
    for chunk in CHUNKS:
        inp = BatchedInpainter(model, dev, chunk=chunk, quantize_uint8=True)
        inp(imgs[:chunk], masks[:chunk])  # warm-up: cuDNN plans at this batch
        rates = []
        for _ in range(2):
            t0 = time.perf_counter()
            inp(imgs, masks)
            rates.append(len(imgs) / (time.perf_counter() - t0))
        line("e2e", chunk=chunk, tiles=len(imgs), tiles_per_s=[f"{r:.2f}" for r in rates])
        rows.append(dict(chunk=chunk, tiles=len(imgs), tiles_per_s=rates))
    return rows


def union_us(intervals) -> float:
    busy, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profiled(run, trace_path: Path, label: str, **fields):
    """Trace run() once: device busy time, idle share of the host's window,
    device time by kernel name (the top 12, and all of them as by_name_ms)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(str(trace_path))
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us()
    busy = union_us((e.time_range.start, e.time_range.end) for e in events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    row = dict(**fields, device_events=len(events),
               window_ms=window_us / 1e3, busy_ms=busy / 1e3,
               idle_share=1.0 - busy / window_us if events else None,
               top_ms={n: t / 1e3 for n, t in top},
               by_name_ms={n: t / 1e3 for n, t in by_name.items()})
    line(label, **{k: v for k, v in row.items() if not k.endswith("_ms") or k in
                   ("window_ms", "busy_ms")})
    for n, t in top:
        line(label, kernel=repr(n[:90]), ms=f"{t / 1e3:.3f}",
             share=f"{t / max(busy, 1e-9):.4f}")
    return row


def trace(model, dev, imgs, masks, out: Path):
    inp = BatchedInpainter(model, dev, chunk=CHUNKS[0], quantize_uint8=True)
    inp(imgs[: CHUNKS[0]], masks[: CHUNKS[0]])
    row = profiled(lambda: inp(imgs, masks), out.with_suffix(".trace.json"), "trace",
                   chunk=CHUNKS[0], tiles=len(imgs))
    k1 = sum(t for n, t in row["by_name_ms"].items() if "upsample2x_fwd" in n)
    row.update(k1_ms=k1, k1_share=k1 / row["busy_ms"])
    line("trace", k1_ms=f"{k1:.3f}", k1_share=f"{row['k1_share']:.5f}")
    return row


def mma_alternative_ms(args, xs, packed, tile: int, splits: int) -> float:
    """K2's MMA kernel on a given tile and split count, past plan_stage,
    timed as the wrapper is; its output held to the wrapper's."""
    x, m, weight, bias, stride, padding, a, bb = args
    b, h, w, ca = x.shape
    cb = 0 if xs is None else xs.shape[-1]
    cout, k = weight.shape[0], weight.shape[-1]
    oh, ow = (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1
    out = torch.empty((b, oh, ow, cout), device=x.device)
    new_mask = torch.empty((b, oh, ow, 1), device=x.device)
    ws = torch.empty((splits, b * oh * ow, cout), device=x.device) if splits > 1 else None
    ratio_ws = torch.empty(b * oh * ow, device=x.device) if splits > 1 else None
    lib = load_library()

    def run():
        check(lib.tg_pconv_eval_mma_f32(
            x.data_ptr(), None if xs is None else xs.data_ptr(), m.data_ptr(),
            packed[0].data_ptr(), packed[1].data_ptr(), bias.data_ptr(), a.data_ptr(),
            bb.data_ptr(), out.data_ptr(), new_mask.data_ptr(),
            None if ws is None else ws.data_ptr(), None if ratio_ws is None else ratio_ws.data_ptr(),
            b, h, w, ca, cb, cout, k, stride, padding, tile, splits, 0,
            torch.cuda.current_stream().cuda_stream), "mma_alternative_ms")

    run()
    want, _ = fused_pconv_eval(*args, x_skip=xs, packed=packed)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    if not err <= 1e-4 * want.abs().max().item():
        raise RuntimeError(f"K2 on tile {tile}, {splits} splits: {err} from the wrapper's output")
    return time_ms(run)


def stage_rates(model, dev):
    rows = []
    for batch in STAGE_BATCHES:
        gen = torch.Generator().manual_seed(SEED + 1)
        batch_rows = []
        for name, h, ca, cb, st in stage_geometries(model, SIZE):
            args, xs, packed = stage_inputs(st, h, ca, cb, batch, gen, dev)
            weight = args[2]
            r = k2_stage(args, xs, packed)
            pack = time_ms(lambda: pack_pconv_weight(weight))
            pack_kernel = time_ms(lambda: pack_pconv_weights([weight]))
            alt = {}
            if r["variant"] == "mma":
                b, oh, ow, cout = map(int, r["out"].split("x"))
                plan = plan_stage(b * oh * ow, cout, ca, cb, weight.shape[-1], sm_count(dev))
                # the plan itself through the same direct call, to compare like with like
                alt["direct_ms"] = mma_alternative_ms(args, xs, packed, plan.tile, plan.splits)
                other = 1 - plan.tile
                if other == 0 or weight.shape[-1] <= 5:  # the 256x64 tile holds k <= 5
                    alt[f"tile_{'x'.join(map(str, MMA_TILES[other]))}_ms"] = mma_alternative_ms(
                        args, xs, packed, other, plan.splits)
                if plan.splits > 1:
                    alt["unsplit_ms"] = mma_alternative_ms(args, xs, packed, plan.tile, 1)
            row = dict(batch=batch, stage=name, variant=r["variant"], tile=r["tile"],
                       splits=r["splits"], ms=r["ms"], plain_ms=r["plain_ms"],
                       library_ms=r["library_ms"], host_ms=r["host_ms"], pack_ms=pack,
                       pack_kernel_ms=pack_kernel,
                       gflop=r["flop"] / 1e9,
                       tflops=r["tflops"], plain_tflops=r["flop"] / r["plain_ms"] / 1e9,
                       library_tflops=r["flop"] / r["library_ms"] / 1e9,
                       bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                       vs_bound=r["ms"] / r["bound_ms"],
                       rel_err=r["max_abs_err"] / max(r["scale"], 1e-30), bitwise=r["bitwise"],
                       **alt)
            line("stage", **{k: f"{v:.4f}" if isinstance(v, float) else v for k, v in row.items()})
            batch_rows.append(row)
            del args, xs
        rows += batch_rows + [total("stage", "stage", batch_rows, batch=batch,
                                    library_ms=sum(r["library_ms"] for r in batch_rows),
                                    **sum_bounds(batch_rows))]
    return rows


def enc1_rates(model, dev, parent_root):
    """enc1 at ENC1_BATCHES by graph replay (chip_smoke.enc1_times), and
    with a parent checkout its enc1 (its SIMT kernel) in turns parent,
    change, change, parent; each version's output held to the plain
    version."""
    parent = build_parent(parent_root, "pconv_eval") if parent_root else None
    if parent:
        parent.tg_pconv_eval_f32.restype = ctypes.c_int
        parent.tg_pconv_eval_f32.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
    gen = torch.Generator().manual_seed(SEED + 15)
    rows = []
    for batch in ENC1_BATCHES:
        args, _, packed = stage_inputs(model.enc1, SIZE, 1, 0, batch, gen, dev)
        x, m = args[:2]
        want, want_m = fused_pconv_eval_plain(*args)
        versions = {}
        if parent:
            old = simt_enc1(args, tuple(want.shape), lib=parent)
            change = lambda xm: fused_pconv_eval(xm[0], xm[1], *args[2:], packed=packed)  # noqa: E731
            for turn_no, turn in enumerate(("parent", "change", "change", "parent")):
                versions[f"turn{turn_no}_{turn}_ms"] = (old if turn == "parent" else change, 1)
        errs = {}
        for name, (fn, _) in versions.items():
            out, out_m = fn((x, m))
            torch.cuda.synchronize()
            errs[name] = (out - want).abs().max().item()
            if not (errs[name] <= K2_REL_TOL * want.abs().max().item() and torch.equal(out_m, want_m)):
                raise RuntimeError(f"enc1 {name} at batch {batch}: {errs[name]} from the plain version")
        r = enc1_times(args, packed, versions)
        empty = graph_device_ms(lambda: empty_launch(dev))[0]
        row = dict(batch=batch, empty_ms=empty, vs_bound=r["ms"] / r["bound_ms"],
                   max_abs_errs={k[:-3]: v for k, v in errs.items()}, **r)
        line("enc1", **{k: f"{v:.5f}" if isinstance(v, float) else v for k, v in row.items()
                        if k not in ("max_abs_errs",)})
        rows.append(row)
        del args, packed, x, m, want, want_m
        torch.cuda.empty_cache()
    return rows


def total(phase: str, key: str, rows, **extra):
    """The rows summed: kernel and plain ms, and the bound of the whole."""
    row = {key: "total", **{k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms")},
           **extra}
    line(phase, **{k: f"{v:.4f}" if isinstance(v, float) else v for k, v in row.items()})
    return row


def tail_rates(model, dev, imgs, masks):
    rows = []
    for b in TAIL_BATCHES:
        x = torch.from_numpy(imgs[:b].astype(np.float32) / 255.0).to(dev)
        m = torch.from_numpy((masks[:b] > 0).astype(np.float32)).to(dev)
        xin = x * m
        d, dm = dec2_outputs(model, xin, m)
        with torch.inference_mode():
            ms = time_ms(lambda: model.fused_tail_forward(d, dm, xin, m, fused_decoder_tail))
            plain = time_ms(lambda: model.fused_tail_forward(d, dm, xin, m,
                                                             fused_decoder_tail_plain))
            unfused = time_ms(lambda: model.tail_forward(d, dm, xin, m, fused_pconv_eval,
                                                         upsample2x_bilinear))
        work = k3_work(*d.shape, skip=False)
        flop = work["dec1"] + work["fp32"]
        weights = sum(p.numel() for p in (*model.dec1.parameters(), *model.final.parameters()))
        moved = 4 * (d.numel() + dm.numel() + 3 * xin.numel() + weights + 4 * d.shape[-1])
        row = dict(batch=b, ms=ms, plain_ms=plain, unfused_ms=unfused, gflop=flop / 1e9,
                   tflops=flop / ms / 1e9, k3_faster=ms < unfused, **k3_bound(work, moved))
        row["vs_bound"] = ms / row["bound_ms"]
        line("tail", **{k: f"{v:.4f}" if isinstance(v, float) else v for k, v in row.items()})
        rows.append(row)
        del d, dm, x, m, xin
    return rows


def drive(client, imgs, masks, concurrency: int, n: int):
    """n /inpaint requests, concurrency at a time: (seconds, latencies in ms)."""
    def one(i):
        t = time.perf_counter()
        client.inpaint(imgs[i % len(imgs)], masks[i % len(imgs)])
        return (time.perf_counter() - t) * 1e3

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        lat = list(pool.map(one, range(n)))
    return time.perf_counter() - t0, lat


def serve_rates(dev, imgs, masks, out: Path):
    rows = []
    service = InpaintService(size=SIZE, out_size=OUTPUT_SIZE, max_batch=SERVE_MAX_BATCH,
                             base_width=WIDTH, device=dev)
    service.warmup()
    srv = make_server(service, "127.0.0.1", 0)
    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    client = InpaintClient(f"http://127.0.0.1:{srv.server_port}")
    try:
        drive(client, imgs, masks, 4, 8)  # warm-up: the codecs and every path
        for concurrency, n in SERVE_LOADS:
            before = service.batcher.snapshot()
            seconds, lat = drive(client, imgs, masks, concurrency, n)
            after = service.batcher.snapshot()
            batches = after["batches"] - before["batches"]
            row = dict(concurrency=concurrency, requests=n,
                       requests_per_s=n / seconds, p50_ms=float(np.percentile(lat, 50)),
                       p95_ms=float(np.percentile(lat, 95)), forwards=batches,
                       mean_batch=(after["batch_size_sum"] - before["batch_size_sum"]) / batches)
            line("serve", **{k: f"{v:.2f}" if isinstance(v, float) else v for k, v in row.items()})
            rows.append(row)
        trace_row = profiled(lambda: drive(client, imgs, masks, 16, 32),
                             out.with_name(out.stem + "_serve.trace.json"), "serve_trace",
                             concurrency=16, requests=32)
        k3 = sum(t for n, t in trace_row["by_name_ms"].items() if "decoder_tail" in n)
        trace_row.update(k3_ms=k3, k3_share=k3 / trace_row["busy_ms"])
        line("serve_trace", k3_ms=f"{k3:.3f}", k3_share=f"{trace_row['k3_share']:.4f}")
    finally:
        srv.shutdown()
        srv.server_close()
    del service
    torch.cuda.empty_cache()
    return rows, trace_row


def train_rates(dev, imgs, masks):
    rows = []
    step = make_train_step()
    for b in TRAIN_BATCHES:
        state, vgg = train_state(SEED + 6, dev)
        batch = device_batch(imgs[:b], masks[:b], dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        try:
            for _ in range(2):  # warm-up: cuDNN plans at this batch
                step(state, batch, vgg)
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(TRAIN_STEPS):
                    step(state, batch, vgg)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) / TRAIN_STEPS * 1e3)
        except torch.cuda.OutOfMemoryError as e:  # a batch that does not fit is a result
            peak = torch.cuda.max_memory_allocated()
            line("train", batch=b, out_of_memory=True, peak_mem_gib=f"{peak / 2**30:.2f}")
            rows.append(dict(batch=b, out_of_memory=str(e).splitlines()[0],
                             peak_mem_gib=peak / 2**30))
            del state, vgg, batch
            torch.cuda.empty_cache()
            continue
        peak = torch.cuda.max_memory_allocated()
        row = dict(batch=b, ms_per_step=runs, samples_per_s=[1e3 * b / ms for ms in runs],
                   peak_mem_gib=peak / 2**30)
        line("train", batch=b, ms_per_step=[f"{v:.2f}" for v in runs],
             samples_per_s=[f"{1e3 * b / v:.2f}" for v in runs], peak_mem_gib=f"{peak / 2**30:.2f}")
        rows.append(row)
        del state, vgg, batch
        torch.cuda.empty_cache()
    return rows


def train_trace(dev, imgs, masks, out: Path):
    b = TRAIN_BATCHES[0]
    state, vgg = train_state(SEED + 6, dev)
    batch = device_batch(imgs[:b], masks[:b], dev)
    step = make_train_step()
    for _ in range(2):
        step(state, batch, vgg)

    def run():
        for _ in range(TRACE_STEPS):
            step(state, batch, vgg)

    row = profiled(run, out.with_name(out.stem + "_train.trace.json"), "train_trace",
                   batch=b, steps=TRACE_STEPS)
    k1b = sum(t for n, t in row["by_name_ms"].items() if "upsample2x_bwd" in n)
    k1f = sum(t for n, t in row["by_name_ms"].items() if "upsample2x_fwd" in n)
    row.update(k1_bwd_ms=k1b, k1_bwd_share=k1b / row["busy_ms"], k1_fwd_ms=k1f,
               k1_fwd_share=k1f / row["busy_ms"])
    line("train_trace", k1_bwd_ms=f"{k1b:.3f}", k1_bwd_share=f"{row['k1_bwd_share']:.5f}",
         k1_fwd_ms=f"{k1f:.3f}", k1_fwd_share=f"{row['k1_fwd_share']:.5f}")
    return row


def build_parent(root: Path, source: str) -> ctypes.CDLL:
    """A parent checkout's csrc/<source>.cu built alone with the port's
    nvcc flags into build/parent_<source>/ and loaded (its C entries
    unbound)."""
    src = root / "terra_gan_tpu_torch" / "csrc" / f"{source}.cu"
    so = BUILD_ROOT.parent / f"parent_{source}" / f"libparent_{source}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True, timeout=600)
    return ctypes.CDLL(str(so))


def parent_k1(root: Path):
    """K1 fwd and bwd of a parent checkout at ``root`` (build_parent),
    called through its C signature (src, dst, N, H, W, C, dtype, stream)
    by the steps its wrappers took: the checks, torch.empty,
    load_library, torch.cuda.device, current_stream, the ctypes call by
    name."""
    lib = build_parent(root, "upsample2x")
    for entry in ("tg_upsample2x_fwd", "tg_upsample2x_bwd"):
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    codes = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}

    def launch(entry, src, dst, small):
        if src.dim() != 4 or src.dtype not in codes or not src.is_contiguous():
            raise ValueError(f"{entry}: needs a contiguous NHWC fp32 or bf16 tensor")
        code, vec = codes[src.dtype]
        n, h, w, c = small
        if c % vec or (src.data_ptr() | dst.data_ptr()) % 16:
            raise ValueError(f"{entry}: needs C % {vec} == 0 and 16-byte aligned tensors")
        if dst.numel() == 0:
            return
        load_library()
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream().cuda_stream
            check(getattr(lib, entry)(src.data_ptr(), dst.data_ptr(), n, h, w, c, code, stream),
                  entry)

    def fwd(x):
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError("the parent's upsample2x_fwd records no gradient")
        n, h, w, c = x.shape
        y = torch.empty((n, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
        launch("tg_upsample2x_fwd", x, y, (n, h, w, c))
        return y

    def bwd(g):
        n, h2, w2, c = g.shape
        if h2 % 2 or w2 % 2:
            raise ValueError(f"the parent's upsample2x_bwd: needs an even size, got {h2}x{w2}")
        dx = torch.empty((n, h2 // 2, w2 // 2, c), dtype=g.dtype, device=g.device)
        launch("tg_upsample2x_bwd", g, dx, (n, h2 // 2, w2 // 2, c))
        return dx

    return {"fwd": fwd, "bwd": bwd}


def k1_alternatives(direction: str, src: torch.Tensor, want: torch.Tensor) -> dict:
    """K1 ``direction`` at src's shape at each tiling plan_upsample could
    pick: the adjoint's 1 and 2 dx rows a thread (the forward's one pixel),
    each at tiles of at most 1, 2, 4 and 8 row blocks, through the C
    entry; each output held bitwise to the wrapper's ``want``; device ms a
    call by graph replay over copies past the L2, as k1_times."""
    if direction == "fwd":
        n, h, w, c = src.shape
    else:
        n, h2, w2, c = src.shape
        h, w = h2 // 2, w2 // 2
    fn = getattr(load_library(), f"tg_upsample2x_{direction}")
    calls = graph_calls(bound(0.0, nbytes(src, want))["bound_ms"])
    srcs = past_l2(src, nbytes(want), calls)
    times = {}
    for rows in (1,) if direction == "fwd" else (1, 2):
        for ht in (1, 2, 4, 8):
            plan = _tiling(direction, n, h, w, c, src.dtype, rows, ht)
            if plan.ht < ht:  # cut to the shape or the block: a smaller ht's tiling
                continue
            tiles, launches = _launch_args(plan, h, w, c, src.dtype)

            def call(x, tiles=tiles, launches=launches):  # tiles: kept alive for the C entry
                out = torch.empty_like(want)
                stream = torch.cuda.current_stream().cuda_stream
                for src_off, dst_off, args in launches:
                    check(fn(x.data_ptr() + src_off, out.data_ptr() + dst_off, *args, stream),
                          "k1_alternatives")
                return out

            got = call(src)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"K1 {direction} at {plan}: not the wrapper's output "
                                   f"({(got - want).abs().max().item()})")
            times[f"rows{rows}_ht{ht}"] = graph_device_ms(rotating(call, srcs), calls)[0]
    return times


def k1_rates(dev, parent_root):
    """K1 fwd and bwd at the 7 decoder shapes at batch 1, 8 and 32, device
    ms by graph replay (chip_smoke.k1_times), and with a parent checkout
    its two kernels in turns (parent, change, change, parent) with the max
    difference of their outputs from the change's; each change turn's
    plain version and library call once; the plan's alternatives in fp32
    and bf16 at SWEEP_BATCHES."""
    parent = parent_k1(parent_root) if parent_root else None
    turns = ("parent", "change", "change", "parent") if parent else ("change",)
    gen = torch.Generator().manual_seed(SEED + 14)
    rows = []
    for batch in K1_BATCHES:
        empty = graph_device_ms(lambda: empty_launch(dev))[0]
        for h, c in upsample_shapes(WIDTH):
            for direction in ("fwd", "bwd"):
                side = h if direction == "fwd" else 2 * h
                src = torch.randn((batch, side, side, c), generator=gen).to(dev)
                port = upsample2x_fwd if direction == "fwd" else upsample2x_bwd
                want = port(src)
                plan = plan_upsample(direction, batch, h, h, c, src.dtype)
                extra = dict(rows=plan.rows, rt=plan.rt, ht=plan.ht, launches=len(plan.chunks))
                if parent:
                    extra["parent_max_abs_diff"] = (parent[direction](src) - want).abs().max().item()
                for turn_no, turn in enumerate(turns):
                    r = k1_times(direction, src, kernel=parent[direction] if turn == "parent" else None,
                                 yardsticks=turn_no == 1 or not parent)
                    row = dict(batch=batch, direction=direction, shape="x".join(map(str, src.shape)),
                               turn_no=turn_no, turn=turn, empty_ms=empty, **extra, **r)
                    k1_line("k1", batch, row["shape"], r, empty, direction=direction, turn=turn,
                            **extra)
                    rows.append(row)
                for x in (src, src.bfloat16()) if batch in SWEEP_BATCHES else ():
                    alt = k1_alternatives(direction, x, port(x))
                    p = plan_upsample(direction, batch, h, h, c, x.dtype)
                    planned, best = f"rows{p.rows}_ht{p.ht}", min(alt, key=alt.get)
                    shape, dtype = "x".join(map(str, src.shape)), str(x.dtype).split(".")[-1]
                    line("k1_plan", batch=batch, direction=direction, shape=shape, dtype=dtype,
                         planned=planned, best=best, best_ms=f"{alt[best]:.5f}",
                         **{k: f"{v:.5f}" for k, v in alt.items()})
                    rows.append(dict(batch=batch, direction=direction, shape=shape, dtype=dtype,
                                     planned=planned, alternatives=alt))
                del src, want
        for direction in ("fwd", "bwd"):
            for turn_no, turn in enumerate(turns):
                rs = [r for r in rows if r.get("turn_no") == turn_no and r["batch"] == batch
                      and r["direction"] == direction]
                t = dict(ms=sum(r["ms"] for r in rs), bound_ms=sum(r["bound_ms"] for r in rs),
                         host_ms=sum(r["host_ms"] for r in rs), call_ms=sum(r["call_ms"] for r in rs))
                if turn_no == 1 or not parent:
                    t.update(plain_ms=sum(r["plain_ms"] for r in rs),
                             library_ms=sum(r["library_ms"] for r in rs))
                line("k1_total", batch=batch, direction=direction, turn=turn, shapes=len(rs),
                     **{k: f"{v:.5f}" for k, v in t.items()})
                rows.append(dict(batch=batch, direction=direction, turn_no=turn_no, turn=turn,
                                 total=True, **t))
    return rows


def parent_probes(root: Path):
    """The probes a parent checkout at ``root`` (build_parent) had in
    another form than this one: P5, bound with its C signature (a, out,
    rows, row elements, stream); P1-P4 have the parent's form."""
    lib = build_parent(root, "probes")
    row_build = lib.tg_probe_row_build
    row_build.restype = ctypes.c_int
    row_build.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]

    def p5(a):
        out = torch.empty_like(a)
        check(row_build(a.data_ptr(), out.data_ptr(), a.shape[0], a.numel() // a.shape[0],
                        torch.cuda.current_stream().cuda_stream), "tg_probe_row_build")
        return out
    return {"probe_row_build": p5}


def p3_tilings(a: torch.Tensor, k2: torch.Tensor, empty: float) -> list:
    """P3 at a and k2 at each tiling the C entry takes for them (R rows of
    CONCAT_ROWS by 4 BQ columns, BQ up to the least that covers N, at most
    CONCAT_THREADS threads; K in one stage or in chunks of 32 columns of a,
    double-buffered), vec4, through the C entry; each output held to the
    plain version; device ms a call by graph replay beside the bytes the
    tiles copy into the busiest SM (plan_probe's measure)."""
    lib = load_library()
    m, c, n = a.numel() // a.shape[-1], a.shape[-1], k2.shape[1]
    plan = plan_probe("probe_lane_concat_dot", a, k2)
    want = PLAIN[probe_lane_concat_dot](a, k2)
    rows_out = []
    for rows in CONCAT_ROWS:
        for bq in (1, 2, 4, 8, 16):
            if 2 * rows * bq > CONCAT_THREADS or (bq > 1 and 2 * bq >= n):
                continue
            for kchunk in (c, 32):
                if concat_smem_bytes(rows, bq, -(-kchunk // 4) * 4,
                                     1 if kchunk == c else 2) > CONCAT_SMEM_BUDGET:
                    continue  # the C entry refuses it
                grid, block = -(-m // rows) * -(-n // (4 * bq)), 2 * rows * bq

                def call(rows=rows, kchunk=kchunk, grid=grid, block=block):
                    out = torch.empty((*a.shape[:-1], n), device=a.device)
                    check(lib.tg_probe_lane_concat_dot(
                        a.data_ptr(), k2.data_ptr(), out.data_ptr(), m, c, n,
                        VARIANTS.index("vec4"), grid, block, rows, kchunk,
                        torch.cuda.current_stream().cuda_stream), "p3_tilings")
                    return out

                err = probe_check("probe_lane_concat_dot", call(), want,
                                  f" rows {rows} bq {bq} kchunk {kchunk}")
                ms, kernels = graph_device_ms(call)
                row = dict(probe="probe_lane_concat_dot", rows=rows, bq=bq, kchunk=kchunk,
                           grid=grid, block=block,
                           busiest_sm_bytes=concat_busiest_sm_bytes(m, c, n, rows, bq),
                           planned=(grid, block, rows, kchunk) == tuple(plan[1:]),
                           device_ms=ms, kernels_per_call=kernels, empty_device_ms=empty,
                           max_abs_err=err)
                line("p3_tiling", **{k: f"{v:.6f}" if isinstance(v, float) else v
                                     for k, v in row.items()})
                rows_out.append(row)
    return rows_out


# (M, C, N) of P3 beside the probe's (1024, 64, 64): K from 4 to 128 at
# M = 1024, then M from 128 to 4096 at C = N = 64
P3_SCALING = ((1024, 4, 64), (1024, 16, 64), (1024, 32, 64), (1024, 64, 64), (1024, 128, 64),
              (128, 64, 64), (256, 64, 64), (512, 64, 64), (2048, 64, 64), (4096, 64, 64))


def p3_scaling(dev, empty: float) -> list:
    """P3 as planned at the shapes of P3_SCALING (seeded uniform inputs):
    device ms by graph replay beside the plan and the empty launch, each
    output held to the plain version. Which part of P3's time follows K
    (the sums and the copies of k2) and which follows M (the blocks)."""
    g = torch.Generator().manual_seed(SEED)
    rows_out = []
    for m, c, n in P3_SCALING:
        a = torch.rand((m, c), generator=g).to(dev)
        k2 = torch.rand((2 * c, n), generator=g).to(dev)
        err = probe_check("probe_lane_concat_dot", probe_lane_concat_dot(a, k2),
                          PLAIN[probe_lane_concat_dot](a, k2), f" at {m}x{c}x{n}")
        ms, kernels = graph_device_ms(lambda: probe_lane_concat_dot(a, k2))
        variant, grid, block, rows, kchunk = plan_probe("probe_lane_concat_dot", a, k2)
        row = dict(probe="probe_lane_concat_dot", m=m, c=c, n=n, variant=variant, grid=grid,
                   block=block, rows=rows, kchunk=kchunk, device_ms=ms,
                   kernels_per_call=kernels, empty_device_ms=empty, max_abs_err=err)
        line("p3_scaling", **{k: f"{v:.6f}" if isinstance(v, float) else v
                              for k, v in row.items()})
        rows_out.append(row)
    return rows_out


def probe_rates(dev, parent_root):
    """P1-P5 at the script's shapes: each variant, the library call (P3's:
    the product alone; P5 has none) and an empty launch, and the parent's
    P5 in turns, by graph replay."""
    a, k1, k2, m = (torch.from_numpy(x).to(dev) for x in probe_inputs())
    k2 = torch.cat([k2, k2])
    cat = torch.cat([a, a * 2.0], -1)  # P3's product alone takes the concat built
    cases = {"probe_lane_reduce": (probe_lane_reduce, (a, k1), torch.matmul),
             "probe_matvec_dot": (probe_matvec_dot, (a, k1[:, None]), torch.matmul),
             "probe_lane_concat_dot": (probe_lane_concat_dot, (a, k2),
                                       lambda a, k2: torch.matmul(cat, k2)),
             "probe_mask_broadcast": (probe_mask_broadcast, (a, m),
                                      lambda a, m: a * m[..., None]),
             "probe_row_build": (probe_row_build, (a,), None)}
    parent = parent_probes(parent_root) if parent_root else None
    turns = ("parent", "change", "change", "parent") if parent else ("change", "change")
    rows = []
    for run, turn in enumerate(turns):
        empty = graph_device_ms(lambda: empty_launch(dev))[0]
        for name, (wrapper, args, library) in cases.items():
            if turn == "parent":
                if name not in parent:
                    continue
                versions = {"parent": lambda: parent[name](*args)}
            else:
                versions = {v: (lambda v=v: wrapper(*args, variant=v)) for v in VARIANTS}
            lib_ms = graph_device_ms(lambda: library(*args))[0] if library else None
            for version, fn in versions.items():
                err = probe_check(name, fn(), PLAIN[wrapper](*args), f" {version}")
                ms, kernels = graph_device_ms(fn)
                row = dict(run=run, turn=turn, probe=name, version=version, device_ms=ms,
                           kernels_per_call=kernels, library_device_ms=lib_ms,
                           library={probe_lane_concat_dot: "product alone",
                                    probe_row_build: "none"}.get(wrapper, "one call"),
                           empty_device_ms=empty, max_abs_err=err)
                line("probes", **{k: f"{v:.6f}" if isinstance(v, float) else v
                                  for k, v in row.items()})
                rows.append(row)
    rows.extend(p3_tilings(a, k2, empty))
    rows.extend(p3_scaling(dev, empty))
    return rows


# one turn of the turns leg, run as a process of its own in a checkout: the
# eval forward of the full-width model there, tiles/s at the given batches
FORWARD_TURN = r"""
import json, sys
import numpy as np, torch
from chip_smoke import SEED, SIZE, WIDTH, dsm_tiles, phase_env, time_ms
from terra_gan_tpu_torch.utils.weights import init_generator

batches = json.loads(sys.argv[1])
phase_env()
dev = torch.device("cuda", 0)
model = init_generator(WIDTH, torch.Generator().manual_seed(SEED), dev)
imgs, masks = dsm_tiles(max(batches), SIZE, SEED)
rates = {}
for b in batches:
    x = torch.from_numpy(imgs[:b].astype(np.float32) / 255.0).to(dev)
    m = torch.from_numpy((masks[:b] > 0).astype(np.float32)).to(dev)
    with torch.inference_mode():
        xm = x * m
        ms = time_ms(lambda: model(xm, m), reps=10, warmup=3)
    rates[b] = {"ms": ms, "tiles_per_s": 1e3 * b / ms}
print(json.dumps(rates))
"""


def forward_turns(parent_root: Path):
    """The eval forward of a parent checkout and of this one, in turns
    parent, change, change, parent, each a process started in its
    checkout (FORWARD_TURN): tiles/s at TURN_BATCHES."""
    here = Path(__file__).resolve().parent
    rows = []
    for turn_no, (turn, root) in enumerate((("parent", parent_root), ("change", here),
                                            ("change", here), ("parent", parent_root))):
        env = {**os.environ, "PYTHONPATH": str(root.resolve())}
        run = subprocess.run([sys.executable, "-c", FORWARD_TURN, json.dumps(TURN_BATCHES)],
                             cwd=root, env=env, capture_output=True, text=True, timeout=900)
        if run.returncode:
            raise RuntimeError(f"the {turn} turn exited {run.returncode}: {run.stderr[-2000:]}")
        rates = json.loads(run.stdout.strip().splitlines()[-1])
        for b, r in rates.items():
            row = dict(turn_no=turn_no, turn=turn, batch=int(b), **r)
            line("turns", **{k: f"{v:.4f}" if isinstance(v, float) else v for k, v in row.items()})
            rows.append(row)
    return rows


# one turn of the epoch leg, run as a process of its own in a checkout:
# train() over PNG tiles, the seconds of each epoch's train loop
EPOCH_TURN = r"""
import json, sys, tempfile
from pathlib import Path
import torch
from chip_smoke import SEED, SIZE, dsm_tiles, phase_env, train_state, write_tiles
from terra_gan_tpu_torch.config import LoopConfig
from terra_gan_tpu_torch.training.loop import train

n_train, n_val, batch, epochs, mask_px = json.loads(sys.argv[1])
phase_env()
torch.backends.cudnn.benchmark = False  # the same convolutions in every turn
dev = torch.device("cuda", 0)
imgs, masks = dsm_tiles(n_train + n_val, SIZE, SEED + 5)
state, vgg = train_state(SEED + 6, dev)
with tempfile.TemporaryDirectory() as tmp:
    root = Path(tmp)
    write_tiles(root / "train", imgs[:n_train], masks[:n_train])
    write_tiles(root / "val", imgs[n_train:], masks[n_train:])
    if mask_px != SIZE:
        from PIL import Image
        for f in sorted(root.glob("*/masks/*.png")):
            Image.open(f).resize((mask_px, mask_px), Image.NEAREST).save(f)
    result = train(root / "train" / "images", root / "train" / "masks", state,
                   LoopConfig(epochs=epochs, batch_size=batch),
                   val_img_dir=root / "val" / "images", val_mask_dir=root / "val" / "masks",
                   vgg=vgg, image_size=SIZE, seed=SEED)
print(json.dumps([{k: r[k] for k in ("epoch", "steps", "epoch_time")}
                  for r in result["history"]]))
"""


def epoch_turns(parent_root: Path):
    """One train() run of a parent checkout and of this one in turns (parent,
    change, change with 4 loader threads twice, change, parent), each a
    process started in its checkout (EPOCH_TURN): seconds an epoch and ms a
    step, the first epoch left out as the warm-up."""
    here = Path(__file__).resolve().parent
    four = {"TERRA_GAN_TPU_FEED_WORKERS": "4"}
    turns = (("parent", parent_root, {}), ("change", here, {}), ("change_4_workers", here, four),
             ("change_4_workers", here, four), ("change", here, {}), ("parent", parent_root, {}))
    rows = []
    for mask_px, (turn_no, (turn, root, extra)) in itertools.product(EPOCH_MASK_PX,
                                                                      enumerate(turns)):
        spec = json.dumps([EPOCH_TILES, EPOCH_VAL, EPOCH_BATCH, EPOCH_RUNS, mask_px])
        env = {k: v for k, v in os.environ.items() if k != "TERRA_GAN_TPU_FEED_WORKERS"}
        env.update(PYTHONPATH=str(root.resolve()), **extra)
        run = subprocess.run([sys.executable, "-c", EPOCH_TURN, spec], cwd=root, env=env,
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            raise RuntimeError(f"the {turn} turn exited {run.returncode}: {run.stderr[-2000:]}")
        hist = json.loads(run.stdout.strip().splitlines()[-1])[1:]
        seconds = [r["epoch_time"] for r in hist]
        row = dict(mask_px=mask_px, turn_no=turn_no, turn=turn, epochs=len(hist),
                   steps=hist[0]["steps"], epoch_s=seconds,
                   ms_per_step=[1e3 * t / r["steps"] for t, r in zip(seconds, hist)])
        line("epoch", mask_px=mask_px, turn_no=turn_no, turn=turn, steps=row["steps"],
             epoch_s=[f"{v:.4f}" for v in seconds],
             ms_per_step=[f"{v:.2f}" for v in row["ms_per_step"]])
        rows.append(row)
    return rows


def sass_functions(lib_path) -> dict:
    """{mangled name, its anonymous namespace's hashes left out: its
    instruction lines} of a built library's SASS (cuobjdump -sass), each
    line address, instruction and encoding."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, fn = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:  # the anonymous namespace's hashes differ from build to build
            fn = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?_cu)_[0-9a-f]{8}", r"_GLOBAL__N__\1",
                        m.group(1))
            funcs[fn] = []
        elif fn is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln):
            funcs[fn].append(" ".join(ln.split()))
    return funcs


def sass_turns(parent: Path) -> dict:
    """SASS_KEPT's functions of the parent's library against this tree's."""
    code = ("from terra_gan_tpu_torch.ops.cuda._build import build_info, load_library; "
            "load_library(); print(build_info()['path'])")
    res = subprocess.run([sys.executable, "-c", code], cwd=parent, capture_output=True,
                         text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"sass: the parent's build exited {res.returncode}: {res.stderr[-2000:]}")
    theirs = sass_functions(res.stdout.strip().splitlines()[-1])
    mine = sass_functions(build_info()["path"])
    names = sorted(fn for fn in theirs if SASS_KEPT.search(fn))
    same = {fn: mine.get(fn) == theirs[fn] for fn in names}
    for fn in names:
        line("sass", function=fn, instructions=len(theirs[fn]), identical=same[fn])
    line("sass", functions=len(names), identical=sum(same.values()),
         differ=[fn for fn, ok in same.items() if not ok])
    if not names or not all(same.values()):
        raise RuntimeError(f"sass: functions differ from the parent's: {same}")
    return {"functions": same, "instructions": {fn: len(theirs[fn]) for fn in names}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/profile_slice.json"))
    ap.add_argument("--legs", default=",".join(DEFAULT_LEGS),
                    help=f"comma-separated legs to run, of {','.join(LEGS)}")
    ap.add_argument("--parent", type=Path, default=None,
                    help="stage, probes, k1, turns, epoch and sass legs: a parent checkout whose "
                         "enc1, P5, K1, eval forward and train() run in turns")
    args = ap.parse_args()
    legs = set(args.legs.split(","))
    if not legs <= set(LEGS):
        ap.error(f"--legs: unknown {sorted(legs - set(LEGS))}")
    if legs & {"turns", "epoch", "sass"} and args.parent is None:
        ap.error("--legs turns, epoch and sass need --parent")
    kind, smi = phase_env()
    phase_build()
    dev = torch.device("cuda", 0)
    imgs, masks = dsm_tiles(E2E_TILES, SIZE, SEED)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    result = dict(device=kind, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  legs=sorted(legs))
    model = init_generator(WIDTH, torch.Generator().manual_seed(SEED), dev)
    if "inference" in legs:
        result.update(forward=forward_rates(model, dev, imgs, masks),
                      e2e=e2e_rates(model, dev, imgs, masks),
                      trace=trace(model, dev, imgs, masks, args.out))
    if "stage" in legs:
        result["stages"] = stage_rates(model, dev)
        result["enc1"] = enc1_rates(model, dev, args.parent)
    if "tail" in legs:
        result["tail"] = tail_rates(model, dev, imgs, masks)
    del model
    torch.cuda.empty_cache()
    if "serve" in legs:
        result["serve"], result["serve_trace"] = serve_rates(dev, imgs, masks, args.out)
    if "train" in legs:
        result.update(
            train=train_rates(dev, imgs, masks),
            train_trace=train_trace(dev, imgs, masks, args.out),
        )
    if "k1" in legs:
        result["k1"] = k1_rates(dev, args.parent)
    if "probes" in legs:
        result["probes"] = probe_rates(dev, args.parent)
    if "turns" in legs:
        result["turns"] = forward_turns(args.parent)
    if "epoch" in legs:
        result["epoch"] = epoch_turns(args.parent)
    if "sass" in legs:
        result["sass"] = sass_turns(args.parent)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"written": str(args.out)}), flush=True)


if __name__ == "__main__":
    main()
