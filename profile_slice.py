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
  4. K2 at each of the 14 stages at batch 8, kernel and plain ms and
     the achieved TFLOP/s, and the wrapper's share in it: the copy of
     nn.Conv2d's weight into the kernel's HWIO layout, timed alone;
  5. the tail per call at batch 1, 8 and 32 on the model's own dec2
     outputs: K3 (the model's eval tail), its plain version and the
     unfused kernel path it replaces (K1, K2's dec1, cuDNN's final conv,
     the composite), ms and K3's TFLOP/s beside its bound.

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
     share, device time by kernel name and K1 backward's share;
 10. K1 backward at the 7 decoder shapes at batch 8, kernel and plain ms
     and the achieved bytes/s.

It prints one line per figure and writes all of them as JSON to --out
(and the traces beside it). Without CUDA it exits nonzero.
"""

from __future__ import annotations

import argparse
import json
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
    SEED, SIZE, WIDTH, bound, dec2_outputs, device_batch, dsm_tiles, holey_mask, line, nbytes,
    phase_build, phase_env, stage_geometries, time_ms, train_state, unfused_forward,
    upsample_shapes,
)
from terra_gan_tpu_torch.evaluation.inference import OUTPUT_SIZE
from terra_gan_tpu_torch.ops.cuda.tail_kernel import fused_decoder_tail, fused_decoder_tail_plain
from terra_gan_tpu_torch.ops.resize import upsample2x_bilinear
from terra_gan_tpu_torch.serving import InpaintClient, InpaintService, make_server
from terra_gan_tpu_torch.ops.cuda.upsample_kernel import upsample2x_bwd, upsample2x_bwd_plain
from terra_gan_tpu_torch.training.step import make_train_step
from terra_gan_tpu_torch.ops.cuda.pconv_kernel import (
    fold_batch_norm,
    fused_pconv_eval,
    fused_pconv_eval_plain,
)
from terra_gan_tpu_torch.parallel.infer import BatchedInpainter
from terra_gan_tpu_torch.utils.weights import init_generator

BATCHES = (1, 8, 16, 32)
TAIL_BATCHES = (1, 8, 32)
SERVE_MAX_BATCH = 16
SERVE_LOADS = ((1, 16), (16, 64))  # (concurrency, requests)
CHUNKS = (8, 16, 32)
E2E_TILES = 32
STAGE_BATCH = 8
TRAIN_BATCHES = (8, 16, 32)
TRAIN_STEPS = 5
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
    return profiled(lambda: inp(imgs, masks), out.with_suffix(".trace.json"), "trace",
                    chunk=CHUNKS[0], tiles=len(imgs))


def stage_rates(model, dev):
    gen = torch.Generator().manual_seed(SEED + 1)
    rows = []
    for name, h, ca, cb, st in stage_geometries(model, SIZE):
        x = torch.rand((STAGE_BATCH, h, h, ca), generator=gen).to(dev)
        xs = torch.rand((STAGE_BATCH, h, h, cb), generator=gen).to(dev) if cb else None
        m = holey_mask(STAGE_BATCH, h, h, gen, dev)
        weight, bias = st.input_conv.weight.detach(), st.input_conv.bias.detach()
        a, bb = fold_batch_norm(st.bn.weight.detach(), st.bn.bias.detach(),
                                st.bn.running_mean, st.bn.running_var, st.bn.eps)
        args = (x, m, weight, bias, st.stride, st.padding, a, bb)
        out, new_mask = fused_pconv_eval(*args, x_skip=xs)
        ms = time_ms(lambda: fused_pconv_eval(*args, x_skip=xs))
        plain = time_ms(lambda: fused_pconv_eval_plain(*args, x_skip=xs))
        relayout = time_ms(lambda: weight.permute(2, 3, 1, 0).contiguous())
        flop = 2.0 * out.numel() * weight[0].numel()
        row = dict(stage=name, ms=ms, plain_ms=plain, relayout_ms=relayout, gflop=flop / 1e9,
                   tflops=flop / ms / 1e9, plain_tflops=flop / plain / 1e9,
                   **bound(flop, nbytes(x, xs, m, weight, bias, a, bb, out, new_mask)))
        line("stage", **{k: f"{v:.4f}" if isinstance(v, float) else v for k, v in row.items()})
        rows.append(row)
    return rows + [total("stage", "stage", rows)]


def total(phase: str, key: str, rows):
    """The rows summed: kernel and plain ms, and the bound of the whole."""
    row = {key: "total", **{k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}}
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
        c = d.shape[-1]
        flop = 2.0 * b * SIZE * SIZE * c * 9 * (c + 1)  # dec1 and the final conv
        weights = sum(p.numel() for p in (*model.dec1.parameters(), *model.final.parameters()))
        moved = 4 * (d.numel() + dm.numel() + 3 * xin.numel() + weights + 4 * c)
        row = dict(batch=b, ms=ms, plain_ms=plain, unfused_ms=unfused, gflop=flop / 1e9,
                   tflops=flop / ms / 1e9, **bound(flop, moved))
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


def k1_bwd_rates(dev):
    gen = torch.Generator().manual_seed(SEED + 4)
    rows = []
    for h, c in upsample_shapes(WIDTH):
        g = torch.randn((STAGE_BATCH, 2 * h, 2 * h, c), generator=gen).to(dev)
        ms = time_ms(lambda: upsample2x_bwd(g))
        plain = time_ms(lambda: upsample2x_bwd_plain(g))
        moved = 4 * (g.numel() + g.numel() // 4)  # read g, write dx
        row = dict(g=f"{STAGE_BATCH}x{2 * h}x{2 * h}x{c}", ms=ms, plain_ms=plain,
                   mbytes=moved / 1e6, gbps=moved / ms / 1e6, plain_gbps=moved / plain / 1e6,
                   **bound(40.0 * g.numel() / 4, moved))
        line("k1_bwd", **{k: f"{v:.4f}" if isinstance(v, float) else v for k, v in row.items()})
        rows.append(row)
    return rows + [total("k1_bwd", "g", rows)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/profile_slice.json"))
    args = ap.parse_args()
    kind, smi = phase_env()
    phase_build()
    dev = torch.device("cuda", 0)
    imgs, masks = dsm_tiles(E2E_TILES, SIZE, SEED)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    result = dict(device=kind, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    model = init_generator(WIDTH, torch.Generator().manual_seed(SEED), dev)
    result.update(
        forward=forward_rates(model, dev, imgs, masks),
        e2e=e2e_rates(model, dev, imgs, masks),
        trace=trace(model, dev, imgs, masks, args.out),
        stages=stage_rates(model, dev),
        tail=tail_rates(model, dev, imgs, masks),
    )
    del model
    torch.cuda.empty_cache()
    result["serve"], result["serve_trace"] = serve_rates(dev, imgs, masks, args.out)
    result.update(
        train=train_rates(dev, imgs, masks),
        train_trace=train_trace(dev, imgs, masks, args.out),
        k1_bwd=k1_bwd_rates(dev),
    )
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"written": str(args.out)}), flush=True)


if __name__ == "__main__":
    main()
