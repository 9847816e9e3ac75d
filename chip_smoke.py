"""Drive the PyTorch port's 512^2 inference, training, serving and CLI paths once on one CUDA card.

    python3 chip_smoke.py

Phases, one line of figures each (any failure raises and exits nonzero):
  1. environment: card, power limit, torch and CUDA versions, TF32 off;
  2. build: the kernels of terra_gan_tpu_torch/csrc with nvcc (sm_90a);
  3. K2 fused_pconv_eval against its plain version at the 14 stage
     geometries of the full-width (base_width=64) 512^2 PConvUNet, batch 2;
  4. K1 upsample2x_fwd against its plain version at the 7 decoder
     shapes, fp32 (torch's bits) and bf16; its fp32 times at batch 8 too;
  5. K1 upsample2x_bwd against torch's own upsample backward at the same
     shapes, fp32 and bf16, and the adjointness <U x, g> = <x, U^T g>;
  6. the slice: 16 synthetic uint8 DSM-like tiles through
     BatchedInpainter(chunk=8) with seeded random weights, held against
     the same model's plain path on the composite and on dec2's
     features, with the kernels' launch counts (13 K2, 6 K1 and 1 K3 a
     forward); the same feature check must fail the plain path run in
     TF32, which shows it can see an error of that size;
  7. files: evaluate on one PNG tile, then inpaint_directory end to end
     on a directory of 512^2 PNGs;
  8. train: the port's train() for one epoch over 24 PNG tiles at batch
     8 (3 steps of G+D with the full loss, VGG perceptual included) and
     one validation batch of 8, with seeded G, D and VGG, fp32, TF32
     off; the launch counts (K1 forward and backward 7 per step, K2 and
     K3 only in validation), the best checkpoint reloaded strictly into
     a fresh state, ms per step, samples/s and peak memory;
  9. train_grad: one batch of 8 through the G objective's forward and
     backward, once through K1 and once through torch's own upsample,
     cuDNN deterministic: the gradient at dec1's upsample input and the
     per-block weight gradients held to one bound, which the plain path
     run in TF32 must exceed;
 10. k3: K3 fused_decoder_tail against its plain version on the
     full-width model's own dec2 features and masks at batch 2, 512^2,
     in the model's one-input form and with a seeded k_skip (the JAX
     form), with the model's tail weights and with seeded tail weights
     whose logits spread over units (features at unit RMS, xm = 0);
     there the plain tail run in TF32 must fail the same bound. Times of
     K3, its plain version and the
     unfused kernel path (K1 + K2 dec1 + cuDNN's final conv + composite);
 11. serve: the port's HTTP server in a thread on 127.0.0.1 with the
     full-width 512^2 model, max_batch 8 and an auth secret; through
     the port's client 16 concurrent /inpaint requests and one
     /inpaint_batch of 4, /healthz, /stats, /metrics and a 401; every
     response within 1 grey level of BatchedInpainter's output with the
     unfused tail, and 1 K3, 13 K2 and 6 K1 launches a forward;
 12. probes: the five probe kernels P1-P5 (csrc/probes.cu) against their
     plain versions at scripts/probe_mosaic.py's shapes and seed (P4 and
     P5 equal, P1-P3 within 1e-6 of max|plain|) and against numpy as
     cli/probe_cuda.py prints it; their times beside an empty launch's,
     per call (CUDA events) and on the device (torch.profiler);
 13. doctor: ``doctor.main([])`` exits 0 with backend, kernel-build,
     model and probes PASS and all five probes OK;
 14. cli: the pipeline CLI's evaluate mode in-process (config read by
     yaml_lite, 2 parent grids of 8 512^2 PNG tiles, a master checkpoint
     of the seeded full-width model): exit 0, every inpainted PNG within
     1 grey level of inpaint_directory with the unfused tail, every
     colored PNG the LUT of its inpainted one, 13 K2, 6 K1 and 1 K3
     launches a forward; ``--mode train`` exits 2.
Then a JSON line of per-kernel figures (each with its bound: the larger
of its bytes over 3.35 TB/s and its operations over the 67 TFLOP/s of
fp32 outside the tensor cores, from this run's shapes), and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without CUDA it exits nonzero before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import logging
import math
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from terra_gan_tpu_torch.cli import doctor, main_pipeline
from terra_gan_tpu_torch.cli.probe_cuda import probe_cases, probe_inputs, run_probes
from terra_gan_tpu_torch.data.visualization import build_lut
from terra_gan_tpu_torch.evaluation.inference import OUTPUT_SIZE, evaluate, inpaint_directory
from terra_gan_tpu_torch.ops.cuda._build import build_info, load_library
from terra_gan_tpu_torch.ops.cuda.probe_kernels import PLAIN, PROBES, empty_launch
from terra_gan_tpu_torch.ops.cuda.pconv_kernel import (
    fold_batch_norm,
    fused_pconv_eval,
    fused_pconv_eval_plain,
)
from terra_gan_tpu_torch.config import LoopConfig
from terra_gan_tpu_torch.ops.cuda.upsample_kernel import (
    upsample2x_bwd,
    upsample2x_bwd_plain,
    upsample2x_fwd,
    upsample2x_fwd_plain,
)
from terra_gan_tpu_torch.ops.cuda.tail_kernel import fused_decoder_tail, fused_decoder_tail_plain
from terra_gan_tpu_torch.ops.resize import upsample2x_bilinear
from terra_gan_tpu_torch.parallel.infer import BatchedInpainter
from terra_gan_tpu_torch.portal import jwt_auth
from terra_gan_tpu_torch.serving import InpaintClient, InpaintService, make_server
from terra_gan_tpu_torch.training.checkpoint import import_pth
from terra_gan_tpu_torch.training.loop import train
from terra_gan_tpu_torch.training.state import GANTrainState
from terra_gan_tpu_torch.training.step import generator_objective, make_train_step
from terra_gan_tpu_torch.utils import yaml_lite
from terra_gan_tpu_torch.utils.weights import init_discriminator, init_generator, init_vgg

SEED = 0
SIZE = 512
WIDTH = 64
STAGE_BATCH = 2
N_TILES = 16
CHUNK = 8
N_FILES = 8
K2_REL_TOL = 1e-4      # of max|plain|: fp32 sums taken in another order
# K1 fwd evaluates torch's own expression for the taps: in fp32 it gives
# torch's bits (the train_grad phase's tight bound rests on that)
K1_F32_ABS_TOL = 0.0
SLICE_NRMSE_TOL = 1e-5  # on the composite
# on dec2's features, the last the eval forward writes before K3: fp32
# sums in another order read far below it, the plain path in TF32 above
# it (the phase checks that it still fails)
FEAT_NRMSE_TOL = 1e-6
SLICE_U8_TOL = 1       # grey levels: a float at a rounding boundary may flip
REPS = 10
K1_BWD_REL_TOL = 1e-6  # of max|plain|: fp32 taps in another order, atomics in torch's
ADJOINT_TOL = 1e-6     # |<Ux,g> - <x,U^T g>| over sum|Ux * g|: fp32 rounding of both sides
N_TRAIN, N_VAL, TRAIN_BATCH = 24, 8, 8
# Gradients of the G objective at 512^2, batch 8, rel L2 of the kernel path
# against the plain path, both at the upsample input and per block. With
# K1 fwd at torch's bits the two differ only in the backward's fp32 sum
# order (K1 bwd gathers, torch adds with atomics), and torch's plain path
# against itself already reads 9e-8 at the upsample input and 1.5e-6 a
# block; the plain path in TF32 reads 7e-2 and 5e-2:
GRAD_TOL = 1e-5
# K3 against its plain version, NRMSE of the composite: fp32 sums in
# another order; the plain tail in TF32 must exceed it on the spread weights
K3_NRMSE_TOL = 1e-5
SERVE_REQUESTS, SERVE_BATCH_ITEMS, SERVE_MAX_BATCH = 16, 4, 8
SERVE_SECRET = "chip-smoke-secret"
K1_B8_BATCH = 8
# P1-P3 against their plain versions, of max|plain|: fp32 sums in another
# order (sums of 64 and 128 products); P4 and P5 round as torch does: equal
PROBE_SUM_REL_TOL = 1e-6
CLI_GRIDS, CLI_TILES = ("NJ05", "SU12"), 8
# scripts/probe_mosaic.py's lines of the probes the kernels replace
PROBE_REPLACES = {"probe_lane_reduce": 45, "probe_matvec_dot": 66, "probe_lane_concat_dot": 91,
                  "probe_mask_broadcast": 117, "probe_row_build": 138}
# the card's peaks (NVIDIA's H100 SXM data sheet): fp32 outside the tensor
# cores and device memory; a kernel's bound is the larger of its two times
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def line(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def time_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flop: float, nbytes: float) -> dict:
    """The least time the card could take for the work, and what bounds it."""
    t_ops, t_bytes = flop / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def nrmse(a, b) -> float:
    """RMS of a - b over max|b|, in f64; numpy arrays or tensors."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return ((a - b).pow(2).mean().sqrt() / b.abs().max().clamp_min(1e-12)).item()


def holey_mask(b: int, h: int, w: int, gen: torch.Generator, dev) -> torch.Tensor:
    """Random 0/1 mask with a solid hole, so some windows are all hole."""
    m = (torch.rand((b, h, w, 1), generator=gen) > 0.25).float()
    m[:, h // 4 : max(h // 4 + 3, 3 * h // 4), w // 4 : max(w // 4 + 3, w // 2)] = 0
    return m.to(dev)


def stage_geometries(model, size: int):
    """(name, H, Ca, Cb, stage module) of the 14 PConv stages at size^2."""
    out = []
    for i in range(1, 8):
        st = getattr(model, f"enc{i}")
        out.append((f"enc{i}", size >> (i - 1), st.input_conv.in_channels, 0, st))
    for n in range(7, 0, -1):
        st = getattr(model, f"dec{n}")
        cb = getattr(model, f"enc{n - 1}").input_conv.out_channels if n > 1 else 0
        out.append((f"dec{n}", size >> (n - 1), st.input_conv.in_channels - cb, cb, st))
    return out


def phase_env():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the plain versions get cuDNN's measured-best algorithm: its default
    # heuristic picks one ~300x slower at the dec3 geometry
    torch.backends.cudnn.benchmark = True
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    line("env", device=repr(kind), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_benchmark=torch.backends.cudnn.benchmark)
    print(smi, flush=True)
    return kind, smi


def phase_build():
    load_library()
    info = build_info()
    line("build", built=info["built"], seconds=f"{info['seconds']:.1f}",
         sources=",".join(info["sources"]), flags=repr(" ".join(info["flags"])),
         lib=info["path"])
    for ln in str(info["log"]).splitlines():
        if "Used" in ln or "spill" in ln:
            print("  ptxas:", ln.strip(), flush=True)


def phase_k2(model, dev):
    gen = torch.Generator().manual_seed(SEED + 1)
    worst_abs, ms, plain_ms, flop, moved = 0.0, 0.0, 0.0, 0.0, 0
    for name, h, ca, cb, st in stage_geometries(model, SIZE):
        x = torch.rand((STAGE_BATCH, h, h, ca), generator=gen).to(dev)
        xs = torch.rand((STAGE_BATCH, h, h, cb), generator=gen).to(dev) if cb else None
        m = holey_mask(STAGE_BATCH, h, h, gen, dev)
        weight, bias = st.input_conv.weight.detach(), st.input_conv.bias.detach()
        a, bb = fold_batch_norm(st.bn.weight.detach(), st.bn.bias.detach(),
                                st.bn.running_mean, st.bn.running_var, st.bn.eps)
        args = (x, m, weight, bias, st.stride, st.padding, a, bb)
        got, got_m = fused_pconv_eval(*args, x_skip=xs)
        want, want_m = fused_pconv_eval_plain(*args, x_skip=xs)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        masks_equal = torch.equal(got_m, want_m)
        t_k = time_ms(lambda: fused_pconv_eval(*args, x_skip=xs))
        t_p = time_ms(lambda: fused_pconv_eval_plain(*args, x_skip=xs))
        k = weight.shape[-1]
        line("k2", stage=name, x=f"{STAGE_BATCH}x{h}x{h}x{ca}+{cb}",
             out="x".join(map(str, got.shape)), k=k, s=st.stride,
             max_abs_err=f"{err:.3e}", rel=f"{err / max(scale, 1e-30):.3e}",
             masks_equal=masks_equal, holes=int((want_m == 0).sum()),
             ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}")
        require(torch.isfinite(got).all().item(), f"K2 {name}: non-finite output")
        require(err <= K2_REL_TOL * scale, f"K2 {name}: err {err} > {K2_REL_TOL} * {scale}")
        require(masks_equal, f"K2 {name}: new_mask differs from the plain version")
        worst_abs, ms, plain_ms = max(worst_abs, err), ms + t_k, plain_ms + t_p
        flop += 2.0 * got.numel() * weight[0].numel()
        moved += nbytes(x, xs, m, weight, bias, a, bb, got, got_m)
    # no one PyTorch call computes a PConv stage (conv, box-sum, renorm, BN, ReLU)
    return dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms, **bound(flop, moved),
                library_ms=None)


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def upsample_shapes(width: int):
    """(H, C) of the 7 decoder upsamples' inputs at SIZE^2."""
    w = width
    return [(SIZE >> 7, 8 * w), (SIZE >> 6, 8 * w), (SIZE >> 5, 8 * w),
            (SIZE >> 4, 8 * w), (SIZE >> 3, 4 * w), (SIZE >> 2, 2 * w),
            (SIZE >> 1, w)]


def phase_k1(model, dev):
    gen = torch.Generator().manual_seed(SEED + 2)
    worst_abs, ms, plain_ms, lib_ms, flop, moved = 0.0, 0.0, 0.0, 0.0, 0.0, 0
    b8 = {"ms": 0.0, "plain_ms": 0.0, "flop": 0.0, "bytes": 0}
    for h, c in upsample_shapes(model.base_width):
        x = torch.rand((STAGE_BATCH, h, h, c), generator=gen).to(dev)
        # fp32 at the profile's batch 8 as well (information only)
        x8 = torch.rand((K1_B8_BATCH, h, h, c), generator=gen).to(dev)
        y8 = upsample2x_fwd(x8)
        b8["ms"] += time_ms(lambda: upsample2x_fwd(x8))
        b8["plain_ms"] += time_ms(lambda: upsample2x_fwd_plain(x8))
        b8["flop"] += 9.0 * y8.numel()
        b8["bytes"] += nbytes(x8, y8)
        del x8, y8
        got, want = upsample2x_fwd(x), upsample2x_fwd_plain(x)
        err = (got - want).abs().max().item()
        xb = x.bfloat16()
        got_b = upsample2x_fwd(xb).float()
        want_b = upsample2x_fwd_plain(xb.float())
        ulps = ((got_b - want_b).abs() / _bf16_ulp(want_b)).max().item()
        t_k = time_ms(lambda: upsample2x_fwd(x))
        t_p = time_ms(lambda: upsample2x_fwd_plain(x))
        t_kb = time_ms(lambda: upsample2x_fwd(xb))
        t_pb = time_ms(lambda: upsample2x_fwd_plain(xb))
        x_nchw = x.permute(0, 3, 1, 2)  # the library call: F.interpolate alone
        t_l = time_ms(lambda: F.interpolate(x_nchw, scale_factor=2, mode="bilinear",
                                            align_corners=False))
        line("k1", x=f"{STAGE_BATCH}x{h}x{h}x{c}", f32_max_abs_err=f"{err:.3e}",
             bf16_max_ulps=f"{ulps:.3f}", ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}",
             library_ms=f"{t_l:.4f}", bf16_ms=f"{t_kb:.4f}", bf16_plain_ms=f"{t_pb:.4f}")
        require(err <= K1_F32_ABS_TOL, f"K1 {h}x{c}: fp32 err {err}: not torch's bits")
        require(ulps <= 1.0, f"K1 {h}x{c}: bf16 off by {ulps} ulp")
        worst_abs, ms, plain_ms = max(worst_abs, err), ms + t_k, plain_ms + t_p
        lib_ms += t_l
        flop += 9.0 * got.numel()  # two FMAs and a multiply per axis pair of taps
        moved += nbytes(x, got)
    b8_bound = bound(b8["flop"], b8["bytes"])
    line("k1_b8", batch=K1_B8_BATCH, shapes=7, ms=f"{b8['ms']:.4f}",
         plain_ms=f"{b8['plain_ms']:.4f}", bound_ms=f"{b8_bound['bound_ms']:.4f}",
         bound_by=b8_bound["bound_by"])
    return dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms, **bound(flop, moved),
                library_ms=lib_ms)


def phase_k1_bwd(model, dev):
    gen = torch.Generator().manual_seed(SEED + 4)
    worst_abs, ms, plain_ms, lib_ms, flop, moved = 0.0, 0.0, 0.0, 0.0, 0.0, 0
    for h, c in upsample_shapes(model.base_width):
        g = torch.randn((STAGE_BATCH, 2 * h, 2 * h, c), generator=gen).to(dev)
        got, want = upsample2x_bwd(g), upsample2x_bwd_plain(g)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        # bf16 on positive data: a sum of positive taps has no cancellation,
        # so the fp32 result of the bf16 inputs is within rounding of exact
        gb = torch.rand((STAGE_BATCH, 2 * h, 2 * h, c), generator=gen).to(dev).bfloat16()
        got_b = upsample2x_bwd(gb).float()
        want_b = upsample2x_bwd_plain(gb.float())
        ulps = ((got_b - want_b).abs() / _bf16_ulp(want_b)).max().item()
        x = torch.randn((STAGE_BATCH, h, h, c), generator=gen).to(dev)
        prod = upsample2x_fwd(x).double() * g.double()
        adj = abs(prod.sum().item() - (x.double() * got.double()).sum().item())
        adj /= prod.abs().sum().item()
        t_k = time_ms(lambda: upsample2x_bwd(g))
        t_p = time_ms(lambda: upsample2x_bwd_plain(g))
        t_kb = time_ms(lambda: upsample2x_bwd(gb))
        t_pb = time_ms(lambda: upsample2x_bwd_plain(gb))
        g_nchw, size = g.permute(0, 3, 1, 2), [STAGE_BATCH, c, h, h]
        t_l = time_ms(lambda: torch.ops.aten.upsample_bilinear2d_backward(
            g_nchw, [2 * h, 2 * h], size, False, 2.0, 2.0))
        line("k1_bwd", g=f"{STAGE_BATCH}x{2 * h}x{2 * h}x{c}", f32_max_abs_err=f"{err:.3e}",
             rel=f"{err / max(scale, 1e-30):.3e}", bf16_max_ulps=f"{ulps:.3f}",
             adjoint_rel=f"{adj:.3e}", ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}",
             library_ms=f"{t_l:.4f}", bf16_ms=f"{t_kb:.4f}", bf16_plain_ms=f"{t_pb:.4f}")
        require(got.shape == (STAGE_BATCH, h, h, c), f"K1 bwd {h}x{c}: shape {tuple(got.shape)}")
        require(err <= K1_BWD_REL_TOL * scale, f"K1 bwd {h}x{c}: fp32 err {err} > 1e-6 * {scale}")
        require(ulps <= 1.0, f"K1 bwd {h}x{c}: bf16 off by {ulps} ulp")
        require(adj <= ADJOINT_TOL, f"K1 bwd {h}x{c}: not the adjoint of K1 fwd ({adj})")
        worst_abs, ms, plain_ms = max(worst_abs, err), ms + t_k, plain_ms + t_p
        lib_ms += t_l
        flop += 40.0 * got.numel()  # 20 FMAs a dx value: 4 rows of 4 taps, then the rows
        moved += nbytes(g, got)
    return dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms, **bound(flop, moved),
                library_ms=lib_ms)


def dsm_tiles(n: int, size: int, seed: int):
    """uint8 DSM-like tiles (smooth relief plus blocks) and 0/255 hole masks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    imgs = np.empty((n, size, size, 1), np.uint8)
    masks = np.full((n, size, size, 1), 255, np.uint8)
    for i in range(n):
        z = np.zeros((size, size), np.float32)
        for _ in range(6):
            fy, fx, ph = rng.uniform(0.5, 4.0), rng.uniform(0.5, 4.0), rng.uniform(0, 6.3)
            z += rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)
        for _ in range(8):  # buildings: flat-topped blocks the holes cut out
            y0, x0 = rng.integers(0, size - 40, 2)
            z[y0 : y0 + rng.integers(8, 40), x0 : x0 + rng.integers(8, 40)] += rng.uniform(0.5, 1.5)
        z = (z - z.min()) / (z.max() - z.min())
        imgs[i, ..., 0] = (z * 255).astype(np.uint8)
        for _ in range(4):
            y0, x0 = rng.integers(0, size - 96, 2)
            masks[i, y0 : y0 + rng.integers(16, 96), x0 : x0 + rng.integers(16, 96)] = 0
    return imgs, masks


@contextlib.contextmanager
def dec2_features(model):
    """Collects dec2's output features, one tensor per forward, while open."""
    feats = []
    hook = model.dec2.register_forward_hook(lambda mod, args, out: feats.append(out[0]))
    try:
        yield feats
    finally:
        hook.remove()


def phase_slice(model, dev, counters):
    imgs, masks = dsm_tiles(N_TILES, SIZE, SEED)
    chunks = [(i, imgs[i : i + CHUNK], masks[i : i + CHUNK]) for i in range(0, N_TILES, CHUNK)]
    inp_f = BatchedInpainter(model, dev, chunk=CHUNK)
    inp_u8 = BatchedInpainter(model, dev, chunk=CHUNK, quantize_uint8=True)
    inp_f(imgs[:CHUNK], masks[:CHUNK])  # warm-up: caches, cuDNN plans
    torch.cuda.synchronize()

    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    with dec2_features(model) as got_feat:
        out_f = np.concatenate([o for _, o in inp_f.stream_from(iter(chunks))])
    t1 = time.perf_counter()
    out_u8 = np.concatenate([o for _, o in inp_u8.stream_from(iter(chunks))])
    t2 = time.perf_counter()
    launches = {fn.__name__: fn.launches for fn in counters}
    forwards = 2 * len(chunks)

    want_f, want_u8 = [], []
    with torch.inference_mode(), dec2_features(model) as want_feat:
        for _, im, mk in chunks:
            x = torch.from_numpy(im.astype(np.float32) / 255.0).to(dev)
            m = torch.from_numpy((mk > 0).astype(np.float32)).to(dev)
            y = model.forward_plain(x * m, m)
            want_f.append(y.cpu().numpy())
            want_u8.append((y.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy())
    # the sensitivity control: the plain path of the last chunk in TF32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode(), dec2_features(model) as tf32_feat:
            model.forward_plain(x * m, m)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want_f, want_u8 = np.concatenate(want_f), np.concatenate(want_u8)
    err = nrmse(out_f, want_f)
    feat_err = nrmse(torch.cat(got_feat), torch.cat(want_feat))
    tf32_err = nrmse(tf32_feat[0], want_feat[-1])
    u8_diff = int(np.abs(out_u8.astype(np.int16) - want_u8.astype(np.int16)).max())
    holes = masks == 0
    line("slice", tiles=N_TILES, chunk=CHUNK, shape="x".join(map(str, out_f.shape)),
         nrmse=f"{err:.3e}", dec2_nrmse=f"{feat_err:.3e}",
         tf32_dec2_nrmse=f"{tf32_err:.3e}", u8_max_diff=u8_diff,
         hole_mean=f"{out_f[holes].mean():.4f}", hole_std=f"{out_f[holes].std():.4f}",
         dec2_std=f"{torch.cat(want_feat).std().item():.4f}", forwards=forwards,
         k2_launches=launches["fused_pconv_eval"], k1_launches=launches["upsample2x_fwd"],
         k3_launches=launches["fused_decoder_tail"],
         float_tiles_per_s=f"{N_TILES / (t1 - t0):.2f}",
         u8_tiles_per_s=f"{N_TILES / (t2 - t1):.2f}",
         peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    require(out_f.shape == (N_TILES, SIZE, SIZE, 1), f"slice: shape {out_f.shape}")
    require(np.isfinite(out_f).all(), "slice: non-finite output")
    require(err <= SLICE_NRMSE_TOL, f"slice: NRMSE {err} > {SLICE_NRMSE_TOL}")
    require(feat_err <= FEAT_NRMSE_TOL, f"slice: dec2 NRMSE {feat_err} > {FEAT_NRMSE_TOL}")
    require(tf32_err > FEAT_NRMSE_TOL,
            f"slice: the dec2 check passes the TF32 plain path ({tf32_err}): it sees nothing")
    require(u8_diff <= SLICE_U8_TOL, f"slice: uint8 off by {u8_diff} grey levels")
    require(np.array_equal(out_f[~holes], imgs[~holes].astype(np.float32) / 255.0),
            "slice: valid pixels are not copied from the input")
    want = {"fused_pconv_eval": 13, "upsample2x_fwd": 6, "upsample2x_bwd": 0,
            "fused_decoder_tail": 1}
    require(all(launches[k] == v * forwards for k, v in want.items()),
            f"slice: launches {launches} in {forwards} forwards, want {want} each")
    return launches


def phase_files(model, dev, counters):
    from PIL import Image

    imgs, masks = dsm_tiles(N_FILES, SIZE, SEED + 3)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        (root / "images").mkdir()
        (root / "masks").mkdir()
        for i in range(N_FILES):
            Image.fromarray(imgs[i, ..., 0]).save(root / "images" / f"t{i:03d}.png")
            Image.fromarray(masks[i, ..., 0]).save(root / "masks" / f"t{i:03d}_mask_resized.png")
        for fn in counters:
            fn.launches = 0
        one = evaluate(root / "images" / "t000.png", root / "masks" / "t000_mask_resized.png",
                       model, root / "one.png")
        one_launches = tuple(fn.launches for fn in counters)
        t0 = time.perf_counter()
        outs = inpaint_directory(model, root / "images", root / "masks", root / "out",
                                 device=dev, chunk=CHUNK)
        seconds = time.perf_counter() - t0
        sizes = {Image.open(p).size for p in [one, *outs]}
        line("files", evaluate_launches=one_launches, tiles=N_FILES, written=len(outs),
             sizes=sorted(sizes), seconds=f"{seconds:.2f}")
        require(one_launches == (13, 6, 0, 1), f"files: evaluate launched {one_launches}")
        require(next(model.parameters()).device == dev, "files: evaluate moved the model")
        require(len(outs) == N_FILES, f"files: wrote {len(outs)} of {N_FILES}")
        require(sizes == {(OUTPUT_SIZE, OUTPUT_SIZE)}, f"files: sizes {sizes}")


def write_tiles(root: Path, imgs, masks) -> None:
    from PIL import Image

    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    for i in range(len(imgs)):
        Image.fromarray(imgs[i, ..., 0]).save(root / "images" / f"t{i:03d}.png")
        Image.fromarray(masks[i, ..., 0]).save(root / "masks" / f"t{i:03d}.png")


def device_batch(imgs, masks, dev):
    return {"image": torch.from_numpy(imgs.astype(np.float32) / 255.0).to(dev),
            "mask": torch.from_numpy((masks > 0).astype(np.float32)).to(dev)}


def train_state(seed: int, dev):
    gen = torch.Generator().manual_seed(seed)
    state = GANTrainState.create(init_generator(WIDTH, gen, dev), init_discriminator(WIDTH, gen, dev))
    return state, init_vgg(gen, dev)


def phase_train(dev, counters):
    imgs, masks = dsm_tiles(N_TRAIN + N_VAL, SIZE, SEED + 5)
    cfg = LoopConfig(epochs=1, batch_size=TRAIN_BATCH)
    state, vgg = train_state(SEED + 6, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = Path(tmp)
        write_tiles(root / "train", imgs[:N_TRAIN], masks[:N_TRAIN])
        write_tiles(root / "val", imgs[N_TRAIN:], masks[N_TRAIN:])
        best = root / "ckpt" / "best.pth"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        result = train(root / "train" / "images", root / "train" / "masks", state, cfg,
                       checkpoint_path=best, val_img_dir=root / "val" / "images",
                       val_mask_dir=root / "val" / "masks", vgg=vgg, image_size=SIZE, seed=SEED)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        peak = torch.cuda.max_memory_allocated()

        fresh, _ = train_state(SEED + 7, dev)
        _, extra = import_pth(best, fresh)
        saved_ok = all(torch.equal(a, b) for a, b in zip(
            state.generator.state_dict().values(), fresh.generator.state_dict().values()))
        saved_ok &= all(torch.equal(a, b) for a, b in zip(
            state.discriminator.state_dict().values(), fresh.discriminator.state_dict().values()))
        for opt, opt2 in ((state.g_opt, fresh.g_opt), (state.d_opt, fresh.d_opt)):
            s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
            saved_ok &= s1.keys() == s2.keys() and all(
                torch.equal(s1[i]["exp_avg"], s2[i]["exp_avg"])
                and torch.equal(s1[i]["exp_avg_sq"], s2[i]["exp_avg_sq"]) for i in s1)
        n_adam = (len(fresh.g_opt.state_dict()["state"]), len(fresh.d_opt.state_dict()["state"]))

    # the step alone on one batch already on the card (information only)
    step_fn = make_train_step(cfg.loss_config())
    batch = device_batch(imgs[:TRAIN_BATCH], masks[:TRAIN_BATCH], dev)
    step_fn(state, batch, vgg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(3):
        step_fn(state, batch, vgg)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t1) / 3 * 1e3

    hist = result["history"]
    steps, val_fwd = hist[0]["steps"], math.ceil(N_VAL / TRAIN_BATCH)
    losses = [hist[0][k] for k in ("g_loss", "d_loss", "real_loss", "fake_loss", "val_g_loss",
                                   "val_d_loss")]
    line("train", tiles=N_TRAIN, val_tiles=N_VAL, batch=TRAIN_BATCH, steps=steps,
         g_loss=f"{losses[0]:.5f}", d_loss=f"{losses[1]:.5f}", val_g_loss=f"{losses[4]:.5f}",
         val_d_loss=f"{losses[5]:.5f}", k2_launches=launches["fused_pconv_eval"],
         k1_fwd_launches=launches["upsample2x_fwd"], k1_bwd_launches=launches["upsample2x_bwd"],
         k3_launches=launches["fused_decoder_tail"],
         train_seconds=f"{seconds:.2f}", ms_per_step=f"{ms_step:.2f}",
         samples_per_s=f"{1e3 * TRAIN_BATCH / ms_step:.2f}",
         peak_mem_gib=f"{peak / 2**30:.2f}", reloaded=saved_ok, adam_entries=n_adam,
         g_training=state.generator.training, checkpoint_epoch=extra.get("epoch"))
    require(all(math.isfinite(v) for v in losses), f"train: non-finite losses {losses}")
    require(steps == N_TRAIN // TRAIN_BATCH and state.step == steps + 4,
            f"train: {steps} steps in the epoch, state.step {state.step}")
    require(launches["upsample2x_bwd"] == 7 * steps,
            f"train: K1 bwd launched {launches['upsample2x_bwd']} times in {steps} steps")
    require(launches["upsample2x_fwd"] == 7 * steps + 6 * val_fwd,
            f"train: K1 fwd launched {launches['upsample2x_fwd']} times: 7 per train step, "
            "6 per validation forward")
    require(launches["fused_pconv_eval"] == 13 * val_fwd
            and launches["fused_decoder_tail"] == val_fwd,
            f"train: K2 and K3 launched {launches['fused_pconv_eval']} and "
            f"{launches['fused_decoder_tail']} times: 13 and 1 per validation forward, "
            "none in a train step")
    require(saved_ok and n_adam[0] == 58 and n_adam[1] == 16,
            f"train: the checkpoint did not reload (Adam entries {n_adam})")
    require(state.generator.training, "train: G left in eval mode after validation")
    return launches


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-300)).item()


def g_objective_grads(state, vgg, batch, snapshot, upsample=None):
    """(gradient at dec1's upsample input, {block: weight gradient}) of one
    forward and backward of the G objective from the snapshot's weights.
    ``upsample``: None for the model's own path (K1 fwd and bwd), else the
    upsample of a train-mode forward through plain torch otherwise."""
    G, D = state.generator, state.discriminator
    G.load_state_dict(snapshot[0])
    D.load_state_dict(snapshot[1])
    G.zero_grad(set_to_none=True)
    up_grad = []

    def capture(mod, args, out):
        # dec2's output feeds only the tail's upsample: its gradient is K1 bwd's output
        out[0].register_hook(up_grad.append)

    forward = None
    if upsample is not None:
        forward = lambda x, m: G._run(  # noqa: E731
            x, m, fused_pconv_eval_plain, upsample, fused_decoder_tail_plain)
    hook = G.dec2.register_forward_hook(capture)
    try:
        total, *_ = generator_objective(state, batch, vgg, LoopConfig().loss_config(),
                                        forward=forward)
        total.backward()
    finally:
        hook.remove()
    blocks = {n: p.grad.detach().clone() for n, p in G.named_parameters()
              if n.endswith("input_conv.weight") or n == "final.weight"}
    return up_grad[0].detach().clone(), blocks


def phase_train_grad(dev, counters):
    imgs, masks = dsm_tiles(TRAIN_BATCH, SIZE, SEED + 8)
    batch = device_batch(imgs, masks, dev)
    state, vgg = train_state(SEED + 9, dev)
    snapshot = (copy.deepcopy(state.generator.state_dict()),
                copy.deepcopy(state.discriminator.state_dict()))
    run = lambda up=None: g_objective_grads(state, vgg, batch, snapshot, up)  # noqa: E731
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        before = [fn.launches for fn in counters]
        got = {"kernel": run()}
        kernel_launches = [fn.launches - b for fn, b in zip(counters, before)]
        plain = run(upsample2x_fwd_plain)
        torch.backends.cudnn.allow_tf32 = True
        try:
            got["tf32"] = run(upsample2x_fwd_plain)
        finally:
            torch.backends.cudnn.allow_tf32 = False
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    up = {k: rel_l2(v[0], plain[0]) for k, v in got.items()}
    blocks = {k: {n: rel_l2(v[1][n], plain[1][n]) for n in plain[1]} for k, v in got.items()}
    worst = {k: max(b.values()) for k, b in blocks.items()}
    line("train_grad", batch=TRAIN_BATCH, up_grad="x".join(map(str, plain[0].shape)),
         kernel_launches=kernel_launches,
         **{f"{k}_up_rel_l2": f"{v:.3e}" for k, v in up.items()},
         **{f"{k}_block_rel_l2_max": f"{v:.3e}" for k, v in worst.items()})
    for n in plain[1]:
        print(f"  {n}: " + " ".join(f"{k}={b[n]:.3e}" for k, b in blocks.items()), flush=True)
    require(kernel_launches == [0, 7, 7, 0], f"train_grad: kernel path launched {kernel_launches}")
    require(up["kernel"] <= GRAD_TOL, f"train_grad: upsample-input gradient off by {up['kernel']}")
    require(worst["kernel"] <= GRAD_TOL, f"train_grad: a block's gradient off by {worst['kernel']}")
    require(up["tf32"] > GRAD_TOL and worst["tf32"] > GRAD_TOL,
            f"train_grad: the checks pass the TF32 plain path ({up['tf32']}, "
            f"{worst['tf32']}): they see nothing")


def unfused_forward(model, x, m):
    """The eval forward on the kernel path with the unfused tail (K1, K2's
    dec1, cuDNN's final conv, the composite): the path K3 replaces."""
    h, hm = model.decode(x, m, fused_pconv_eval, upsample2x_bilinear)
    return model.tail_forward(h, hm, x, m, fused_pconv_eval, upsample2x_bilinear)


@contextlib.contextmanager
def unfused_tail(model):
    """The model, whose forward runs the unfused tail while open."""
    model.forward = lambda x, m: unfused_forward(model, x, m)
    try:
        yield model
    finally:
        del model.forward


def dec2_outputs(model, x, m):
    """dec2's (features, mask) in the model's own eval forward (the kernel path)."""
    out = []
    hook = model.dec2.register_forward_hook(lambda mod, args, res: out.append(res))
    try:
        with torch.inference_mode():
            model(x, m)
    finally:
        hook.remove()
    return out[0]


def spread_tail_weights(c: int, dev, seed: int):
    """Tail weights drawn as tests/test_tail_kernel.py draws them: on the
    model's dec2 features the logits spread over units, so an error in the
    tail reaches the composite (with random model weights the holes sit
    near sigmoid(0))."""
    rng = np.random.default_rng(seed)
    n = lambda s, *shape: rng.normal(0, s, shape).astype(np.float32)  # noqa: E731
    u = lambda *shape: rng.random(shape, dtype=np.float32) + 0.5  # noqa: E731
    w = [n(0.05, 3, 3, c, c), n(0.01, c), u(c), n(0.01, c), n(0.01, c), u(c),
         n(0.05, 3, 3, c, 1), np.array([0.01], np.float32)]
    return [torch.from_numpy(a).to(dev) for a in w]


def phase_k3(model, dev):
    imgs, masks = dsm_tiles(STAGE_BATCH, SIZE, SEED + 10)
    x = torch.from_numpy(imgs.astype(np.float32) / 255.0).to(dev)
    m = torch.from_numpy((masks > 0).astype(np.float32)).to(dev)
    xin = x * m
    d, dm = dec2_outputs(model, xin, m)
    conv, bn, fin = model.dec1.input_conv, model.dec1.bn, model.final
    c = d.shape[-1]
    with torch.inference_mode():
        own = [conv.weight.permute(2, 3, 1, 0), conv.bias, bn.weight, bn.bias, bn.running_mean,
               bn.running_var, fin.weight.permute(2, 3, 1, 0), fin.bias]
        own = [t.detach().contiguous() for t in own]
    spread = spread_tail_weights(c, dev, SEED + 12)
    k_skip = torch.from_numpy(
        np.random.default_rng(SEED + 13).normal(0, 0.05, (3, 3, 1, c)).astype(np.float32)).to(dev)

    # the random model's dec2 features are small (each layer's default init
    # shrinks them); the spread weights see them at unit RMS, the scale of
    # the JAX tests' uniform draws, and with xm = 0, so that every pixel is
    # the tail's own output and none is copied from x exactly
    d_unit = d / d.pow(2).mean().sqrt()
    no_mask = torch.zeros_like(m)

    def args(w, skip):
        if w is own:
            return (d, dm, xin, m, w[0], k_skip if skip else None, *w[1:], bn.eps)
        return (d_unit, dm, xin, no_mask, w[0], k_skip if skip else None, *w[1:], bn.eps)
    errs = {}
    with torch.inference_mode():
        for wname, w in (("model", own), ("spread", spread)):
            for skip in (False, True):
                a = args(w, skip)
                got = fused_decoder_tail(*a)
                want = fused_decoder_tail_plain(*a)
                torch.cuda.synchronize()
                key = f"{wname}_{'skip' if skip else 'one_input'}"
                hole = want[a[3] == 0].double()  # sigmoid(logit) where xm = 0
                errs[key] = (nrmse(got, want), (got - want).abs().max().item(),
                             torch.log(hole / (1 - hole)).std().item())
                require(got.shape == (STAGE_BATCH, SIZE, SIZE, 1) and torch.isfinite(got).all().item(),
                        f"k3 {key}: shape {tuple(got.shape)} or non-finite output")
                if wname == "spread":
                    torch.backends.cudnn.allow_tf32 = True
                    try:
                        tf32 = fused_decoder_tail_plain(*a)
                    finally:
                        torch.backends.cudnn.allow_tf32 = False
                    errs[key + "_tf32"] = (nrmse(tf32, want), (tf32 - want).abs().max().item(), 0.0)

        a = args(own, False)
        t_k = time_ms(lambda: fused_decoder_tail(*a))
        t_p = time_ms(lambda: fused_decoder_tail_plain(*a))
        t_u = time_ms(lambda: model.tail_forward(d, dm, xin, m, fused_pconv_eval, upsample2x_bilinear))
        unfused = model.tail_forward(d, dm, xin, m, fused_pconv_eval, upsample2x_bilinear)
        fused = fused_decoder_tail(*a)
        vs_unfused = nrmse(fused, unfused)
    hw = 4 * d.shape[1] * d.shape[2]
    flop = 2.0 * STAGE_BATCH * hw * c * 9 * (c + 1)  # dec1, and the final conv
    # library_ms: the unfused kernel path the fused tail replaces; no one
    # PyTorch call computes the tail
    fig = dict(ms=t_k, plain_ms=t_p, library_ms=t_u,
               **bound(flop, nbytes(d, dm, xin, m, fused, *own)))
    for key, (e, mx, logit_std) in errs.items():
        line("k3", form=key, nrmse=f"{e:.3e}", max_abs_err=f"{mx:.3e}",
             hole_logit_std=f"{logit_std:.4f}" if logit_std else "-")
    line("k3", d="x".join(map(str, d.shape)), ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}",
         unfused_kernel_path_ms=f"{t_u:.4f}", bound_ms=f"{fig['bound_ms']:.4f}",
         bound_by=fig["bound_by"], gflop=f"{flop / 1e9:.2f}",
         tflops=f"{flop / t_k / 1e9:.2f}", nrmse_vs_unfused=f"{vs_unfused:.3e}")
    for key, (e, _, _) in errs.items():
        if key.endswith("_tf32"):
            require(e > K3_NRMSE_TOL,
                    f"k3: the bound passes the TF32 plain tail ({key}: {e}): it sees nothing")
        else:
            require(e <= K3_NRMSE_TOL, f"k3 {key}: NRMSE {e} > {K3_NRMSE_TOL}")
    require(vs_unfused <= K3_NRMSE_TOL, f"k3: {vs_unfused} from the unfused kernel path")
    fig["max_abs_err"] = max(mx for k, (_, mx, _) in errs.items() if not k.endswith("_tf32"))
    return fig


def http_get(url: str, token=None):
    req = urllib.request.Request(url, headers={"Authorization": f"Bearer {token}"} if token else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def phase_serve(dev, counters):
    from PIL import Image

    n = SERVE_REQUESTS + SERVE_BATCH_ITEMS
    imgs, masks = dsm_tiles(n, SIZE, SEED + 11)
    service = InpaintService(size=SIZE, out_size=OUTPUT_SIZE, max_batch=SERVE_MAX_BATCH,
                             base_width=WIDTH, device=dev)
    service.warmup()
    srv = make_server(service, "127.0.0.1", 0, auth_secret=SERVE_SECRET)
    srv.daemon_threads = False  # server_close joins in-flight handlers: the drain
    serving = threading.Thread(target=srv.serve_forever)
    serving.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    client = InpaintClient(url, auth_secret=SERVE_SECRET)
    outs, lat = [None] * n, [0.0] * SERVE_REQUESTS
    try:
        health = client.healthz()

        def one(i):
            t = time.perf_counter()
            outs[i] = client.inpaint(imgs[i], masks[i])
            lat[i] = (time.perf_counter() - t) * 1e3

        batches0 = service.batcher.snapshot()["batches"]
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        workers = [threading.Thread(target=one, args=(i,)) for i in range(SERVE_REQUESTS)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        seconds = time.perf_counter() - t0
        outs[SERVE_REQUESTS:] = client.inpaint_batch(
            [(imgs[i], masks[i]) for i in range(SERVE_REQUESTS, n)])
        launches = {fn.__name__: fn.launches for fn in counters}
        forwards = service.batcher.snapshot()["batches"] - batches0
        stats = client.stats()
        token = jwt_auth.encode({"sub": "chip-smoke"}, SERVE_SECRET, expires_in=300)
        metrics_code, metrics = http_get(f"{url}/metrics", token)
        no_token = http_get(f"{url}/stats")[0]
    finally:
        srv.shutdown()
        serving.join(60)
        srv.server_close()
    # the reference: the same tiles through BatchedInpainter with the unfused
    # tail, resized to the output contract as the server resizes
    with unfused_tail(service.generator) as model:
        ref = BatchedInpainter(model, dev, chunk=CHUNK, quantize_uint8=True)(imgs, masks)
    ref = [np.asarray(Image.fromarray(r[..., 0]).resize((OUTPUT_SIZE, OUTPUT_SIZE), Image.BILINEAR))
           for r in ref]
    diff = max(int(np.abs(o.astype(np.int16) - r.astype(np.int16)).max()) for o, r in zip(outs, ref))
    kind = torch.cuda.get_device_name(0)
    line("serve", requests=SERVE_REQUESTS, batch_items=SERVE_BATCH_ITEMS, forwards=forwards,
         mean_batch=f"{stats['mean_batch']:.2f}", u8_max_diff_vs_unfused=diff,
         k3_launches=launches["fused_decoder_tail"], k2_launches=launches["fused_pconv_eval"],
         k1_launches=launches["upsample2x_fwd"],
         p50_ms=f"{np.percentile(lat, 50):.2f}", p95_ms=f"{np.percentile(lat, 95):.2f}",
         server_p50_ms=stats["latency_p50_ms"], server_p95_ms=stats["latency_p95_ms"],
         requests_per_s=f"{SERVE_REQUESTS / seconds:.2f}", health_devices=health["devices"],
         metrics_code=metrics_code, no_token_code=no_token)
    require(all(o is not None and o.shape == (OUTPUT_SIZE, OUTPUT_SIZE) and o.dtype == np.uint8
                for o in outs), "serve: a response is not a 500x500 grey PNG")
    require(diff <= SLICE_U8_TOL, f"serve: {diff} grey levels from the unfused path")
    require(health["status"] == "ok" and kind in health["devices"],
            f"serve: healthz {health}")
    require(stats["requests"] == n and stats["errors"] == 0 and stats["mean_batch"] > 1,
            f"serve: stats {stats}: requests were not coalesced")
    require(metrics_code == 200 and f"terra_gan_tpu_requests_total {n}" in metrics,
            f"serve: /metrics {metrics_code} {metrics[:200]}")
    require(no_token == 401, f"serve: a request without a token got {no_token}")
    want = {"fused_decoder_tail": 1, "fused_pconv_eval": 13, "upsample2x_fwd": 6,
            "upsample2x_bwd": 0}
    require(all(launches[k] == v * forwards for k, v in want.items()),
            f"serve: launches {launches} in {forwards} forwards, want {want} each")
    return launches


def probe_work(name: str, args, out) -> dict:
    """The bound of one probe call: each input read and the output written
    once, and its operations."""
    a = args[0]
    flop = {"probe_lane_reduce": 2.0 * a.numel(), "probe_matvec_dot": 2.0 * a.numel(),
            # the 2a half, then the K = 2C product
            "probe_lane_concat_dot": a.numel() + 2.0 * out.numel() * 2 * a.shape[-1],
            "probe_mask_broadcast": float(a.numel()),
            "probe_row_build": 3.0 * (a.numel() - a[0].numel())}[name]
    return bound(flop, nbytes(*args, out))


def device_ms(fn, calls: int = 20) -> float:
    """Device time a call of fn takes on the card, from torch.profiler's device
    events (information only: at 256 KiB a per-call CUDA-event time is the
    host's launch cost, since the card idles between calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in events) / calls / 1e3


def phase_probes(dev):
    """P1-P5 against their plain versions at probe_mosaic's shapes and seed,
    then against numpy as probe_cuda prints it; times beside an empty launch."""
    libraries = {"probe_lane_reduce": torch.matmul, "probe_matvec_dot": torch.matmul,
                 "probe_mask_broadcast": lambda a, m: a * m[..., None]}
    empty_ms = time_ms(lambda: empty_launch(dev))
    empty_device_ms = device_ms(lambda: empty_launch(dev))
    figures = {}
    for _, fn, np_args, _, _ in probe_cases(*probe_inputs()):
        name = fn.__name__
        args = [torch.from_numpy(x).to(dev) for x in np_args]
        got, want = fn(*args), PLAIN[fn](*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        exact = name in ("probe_mask_broadcast", "probe_row_build")
        t_k = time_ms(lambda: fn(*args))
        t_p = time_ms(lambda: PLAIN[fn](*args))
        t_l = time_ms(lambda: libraries[name](*args)) if name in libraries else None
        t_dev = device_ms(lambda: fn(*args))
        fig = dict(max_abs_err=err, ms=t_k, plain_ms=t_p, **probe_work(name, args, got),
                   library_ms=t_l)
        line("probes", probe=name, args="+".join("x".join(map(str, a.shape)) for a in args),
             out="x".join(map(str, got.shape)), max_abs_err=f"{err:.3e}",
             rel=f"{err / max(scale, 1e-30):.3e}", ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}",
             library_ms="none" if t_l is None else f"{t_l:.4f}", empty_launch_ms=f"{empty_ms:.4f}",
             device_ms=f"{t_dev:.5f}", empty_device_ms=f"{empty_device_ms:.5f}",
             bound_ms=f"{fig['bound_ms']:.6f}", bound_by=fig["bound_by"])
        require(got.shape == want.shape, f"probes {name}: shape {tuple(got.shape)}")
        if exact:
            require(torch.equal(got, want), f"probes {name}: not equal to its plain version ({err})")
        else:
            require(err <= PROBE_SUM_REL_TOL * scale,
                    f"probes {name}: err {err} > {PROBE_SUM_REL_TOL} * {scale}")
        figures[name] = fig
    results = run_probes(dev)
    for r in results:
        print("  probe_cuda:", r.line(), flush=True)
    require(all(r.ok for r in results), "probes: a probe failed against numpy")
    line("probes", empty_launch_ms=f"{empty_ms:.4f}", empty_device_ms=f"{empty_device_ms:.5f}")
    return figures


def phase_doctor(counters):
    """doctor.main([]) on the card: exit 0, no FAIL or WARN on the rows the
    card decides, and all five probes OK."""
    out = io.StringIO()
    for fn in counters:
        fn.launches = 0
    with contextlib.redirect_stdout(out):
        code = doctor.main([])
    launches = {fn.__name__: fn.launches for fn in counters}
    text = out.getvalue()
    print(text, end="", flush=True)
    rows = dict((name, status) for status, name in re.findall(r"\[(\w+)\s*\] (\S+)", text))
    line("doctor", exit=code, rows=rows, launches=launches)
    require(code == 0, f"doctor: exit {code}")
    for name in ("backend", "kernel-build", "model", "probes"):
        require(rows.get(name) == "PASS", f"doctor: {name} is {rows.get(name)}")
    require(text.count(" OK maxerr=") == 5, "doctor: the probes row does not show five OKs")
    return launches


CLI_CONFIG = """\
# the CLI phase's config: full-width checkpoint, 512^2 tiles
evaluation:
  checkpoint_dir: "ckpts"   # master_checkpoint.pth lives here
experiment_tracking:
  enabled: false
data:
  processed_dir: data/processed
  output_dir: data/output
  image_size: 512
"""


def phase_cli(dev, counters):
    """The pipeline CLI's evaluate mode in-process on a processed tree of
    512^2 PNG tiles, held to inpaint_directory with the unfused tail."""
    from PIL import Image

    cfg = yaml_lite.loads(CLI_CONFIG)
    require(cfg == {"evaluation": {"checkpoint_dir": "ckpts"},
                    "experiment_tracking": {"enabled": False},
                    "data": {"processed_dir": "data/processed", "output_dir": "data/output",
                             "image_size": 512}}, f"cli: yaml_lite read {cfg}")
    model = init_generator(WIDTH, torch.Generator().manual_seed(SEED), dev)
    lut = build_lut()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp, contextlib.chdir(tmp):
        Path("config.yaml").write_text(CLI_CONFIG)
        Path("ckpts").mkdir()
        torch.save({"epoch": 0, "generator_state_dict": {
            k: v.cpu() for k, v in model.state_dict().items()}}, "ckpts/master_checkpoint.pth")
        for g, grid in enumerate(CLI_GRIDS):
            imgs, masks = dsm_tiles(CLI_TILES, SIZE, SEED + 20 + g)
            split = Path("data/processed") / grid / "test"
            (split / "images").mkdir(parents=True)
            (split / "masks").mkdir(parents=True)
            for i in range(CLI_TILES):
                stem = f"{grid.lower()}{i:02d}{i:02d}"
                Image.fromarray(imgs[i, ..., 0]).save(split / "images" / f"{stem}.png")
                Image.fromarray(masks[i, ..., 0]).save(split / "masks" / f"{stem}_mask_resized.png")
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        try:
            code = main_pipeline.main(["--mode", "evaluate", "--config", "config.yaml"])
            seconds = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counters}
            train_code = main_pipeline.main(["--mode", "train", "--config", "config.yaml"])
        finally:
            for h in logging.root.handlers[:]:  # the CLI's log file lives in tmp
                logging.root.removeHandler(h)
                h.close()
        diff, n_png, lut_ok = 0, 0, True
        for grid in CLI_GRIDS:
            split = Path("data/processed") / grid / "test"
            ref_dir = Path("ref") / grid
            with unfused_tail(model) as unfused:
                inpaint_directory(unfused, split / "images", split / "masks", ref_dir, device=dev)
            for ref in sorted(ref_dir.glob("*_inpainted.png")):
                got = np.asarray(Image.open(Path("data/output") / grid / "inpainted" / ref.name))
                want = np.asarray(Image.open(ref))
                diff = max(diff, int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()))
                colored = Path("data/output") / grid / "colored" / f"{ref.stem}_colored.png"
                lut_ok &= np.array_equal(np.asarray(Image.open(colored)), lut[got])
                n_png += 1
    forwards = len(CLI_GRIDS) * math.ceil(CLI_TILES / CHUNK)
    line("cli", exit=code, train_exit=train_code, grids=len(CLI_GRIDS), tiles=n_png,
         u8_max_diff_vs_unfused=diff, colored_is_lut=lut_ok, forwards=forwards,
         seconds=f"{seconds:.2f}", k2_launches=launches["fused_pconv_eval"],
         k1_launches=launches["upsample2x_fwd"], k3_launches=launches["fused_decoder_tail"])
    require(code == 0, f"cli: evaluate exited {code}")
    require(train_code == 2, f"cli: --mode train exited {train_code}, not 2")
    require(n_png == len(CLI_GRIDS) * CLI_TILES, f"cli: {n_png} tiles written")
    require(diff <= SLICE_U8_TOL, f"cli: {diff} grey levels from the unfused path")
    require(lut_ok, "cli: a colored PNG is not the LUT of its inpainted PNG")
    want = {"fused_pconv_eval": 13, "upsample2x_fwd": 6, "upsample2x_bwd": 0,
            "fused_decoder_tail": 1}
    require(all(launches[k] == v * forwards for k, v in want.items()),
            f"cli: launches {launches} in {forwards} forwards, want {want} each")
    return launches


def main() -> None:
    kind, _ = phase_env()
    phase_build()

    dev = torch.device("cuda", 0)
    model = init_generator(WIDTH, torch.Generator().manual_seed(SEED), dev)
    figures = {"fused_pconv_eval": phase_k2(model, dev), "upsample2x_fwd": phase_k1(model, dev),
               "upsample2x_bwd": phase_k1_bwd(model, dev)}
    counters = (fused_pconv_eval, upsample2x_fwd, upsample2x_bwd, fused_decoder_tail)
    runs = [phase_slice(model, dev, counters)]
    phase_files(model, dev, counters)
    figures["fused_decoder_tail"] = phase_k3(model, dev)
    del model
    # launches: the main paths' runs, the inference slice, the train epoch,
    # serving, the doctor and the CLI's evaluate
    runs.append(phase_train(dev, counters))
    phase_train_grad(dev, counters)
    runs.append(phase_serve(dev, counters))
    figures.update(phase_probes(dev))
    runs.append(phase_doctor(counters + PROBES))
    runs.append(phase_cli(dev, counters + PROBES))
    launches = {fn.__name__: 0 for fn in counters + PROBES}
    for run in runs:
        for name, n in run.items():
            launches[name] += n

    sources = {
        "fused_pconv_eval": ("pconv_eval.cu", "terra_gan_tpu/ops/pallas/pconv_kernel.py:297"),
        "upsample2x_fwd": ("upsample2x.cu", "terra_gan_tpu/ops/pallas/upsample_kernel.py:198"),
        "upsample2x_bwd": ("upsample2x.cu", "terra_gan_tpu/ops/pallas/upsample_kernel.py:204"),
        "fused_decoder_tail": ("decoder_tail.cu", "terra_gan_tpu/ops/pallas/tail_kernel.py:226"),
        **{name: ("probes.cu", f"scripts/probe_mosaic.py:{ln}")
           for name, ln in PROBE_REPLACES.items()},
    }
    require(all(launches[name] > 0 for name in sources),
            f"a kernel of the main paths was never launched there: {launches}")
    kernels = [
        {"name": name, "route": "cuda", "source": f"terra_gan_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[name], **figures[name]}
        for name, (src, replaces) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
