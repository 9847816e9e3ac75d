"""Drive the PyTorch port's 512^2 inference, training, serving, CLI and human-guided paths once on one CUDA card.

    python3 chip_smoke.py

Phases, one line of figures each (any failure raises and exits nonzero):
  1. environment: card, power limit, torch and CUDA versions, TF32 off;
  2. build: the kernels of terra_gan_tpu_torch/csrc with nvcc (sm_90a),
     and per kernel ptxas's registers, spills and static shared memory
     and the tensor-core instructions (HMMA, HGMMA) in its SASS
     (cuobjdump -sass); K2's and K3's MMA kernels must have some, and no
     K2 or K3 kernel may spill; K2's one-channel (enc1) kernel's
     tensor-core count, dynamic shared memory and blocks an SM, and K3's
     shared memory and blocks an SM; P1's, P2's and P4's 14 kernels (P1
     and P2 share 6 lane counts x 2 variants, P4 2 variants), P3's 2
     (vec4 and scalar, at most 64 registers), P5's 2 (vec4 and scalar)
     and K1's 6 (fwd in fp32 and bf16, bwd in each at 1 and 2 rows a
     thread) must not spill either;
  3. K2 fused_pconv_eval against its plain version at the 14 stage
     geometries of the full-width (base_width=64) 512^2 PConvUNet, batch 2,
     with the stage's weight planes packed once: per stage its variant
     (3xTF32 MMA, split-K, or enc1's one-channel variant), split count,
     TFLOP/s, and the time of one cuDNN fp32 conv of the same masked input
     (channels_last, the yardstick: the conv alone); two calls must be
     bitwise equal; then enc1 at batch 2 and 8 by CUDA graph replay
     (k1_times' method: one kernel node a call, inputs rotated past the
     L2) beside its plain version, cuDNN's conv alone, the SIMT kernel
     enc1 ran on before (still built for other channel counts), an empty
     launch and its bound; then K2's train variant (fused_pconv_train, the
     partial conv before BatchNorm) against its plain version at the 14
     stages at batches 5, 16 and 32 (NRMSE 1e-5, new_mask equal), its
     forward's time beside the plain stage's with cuDNN's search off (as
     the port trains) and on; its 5 kernels built, the MMA and one-channel
     ones with HMMA; then ffc_local (csrc/ffc_conv.cu, Big-LaMa's block
     FFC: y_l = l2l(x_l) + g2l(x_g), y_g = l2g(x_l) + s, 3x3 reflect) at
     64^2, 128 + 384 channels, batches 16, 8 and 5 against its plain
     version in float64 (NRMSE 1e-6 for y_l and y_g, the plain version in
     TF32 failing it), bitwise over two calls, FFCLocal's gradients
     (its backward's kernels) against autograd through the plain version
     in float64 (rel L2 1e-5; cuDNN's fp32 beside it), its time
     beside the plain version's (cuDNN's heuristic, its search off, as the
     port trained, and in a fresh process with the search on) and the
     bound; four other shapes; then its backward's two kernels,
     ffc_local_dgrad (the frame and border kernels, the forward's body
     on the gradients, then the reflect fold) and ffc_local_wgrad (split
     over the SMs, the splits added in a fixed order), at the same batches against
     their plain versions in float64 (NRMSE 1e-6, the plain versions in
     TF32 failing it), bitwise over two calls, their times beside the
     plain path's (today's three convolution_backward calls and the pads'
     backward, cuDNN's heuristic, and cuDNN searched as the yardstick
     library_ms, each timed in a fresh process) and the bound;
  4. K1 upsample2x_fwd against its plain version at the 7 decoder
     shapes at batch 2 and 8, fp32 (torch's bits) and, at batch 2, bf16
     (1 ulp); per shape the device ms a call by CUDA graph replay of the
     kernel (one kernel node a call), its plain version, F.interpolate and
     an empty launch, with the calls a graph scaled to a replay of about
     GRAPH_MIN_MS (at most 1000), rotating over copies of the input (and
     outputs) that together pass twice the 50 MB L2, beside the byte
     bound, the wrapper's host ms a call and the per-call CUDA-event ms
     (call_ms);
  5. K1 upsample2x_bwd the same way against torch's own upsample backward
     (upsample_bilinear2d_backward, also its library call), fp32 and, at
     batch 2, bf16 and the adjointness <U x, g> = <x, U^T g>;
     then pack_pconv_weights, the one launch a forward that packs K2's
     TF32 weight planes of all 14 stages, against the plain packing
     (bitwise);
  6. the slice: 16 synthetic uint8 DSM-like tiles through
     BatchedInpainter(chunk=8) with seeded random weights, held against
     the same model's plain path on the composite and on dec2's
     features, with the kernels' launch counts (13 K2, 6 K1 and 1 K3 a
     forward; K2's launches by variant: 1 one-channel (enc1), 0 SIMT,
     the rest MMA; 1 pack a forward); the same
     feature check must fail the plain path run in TF32, which shows it
     can see an error of that size;
  7. files: evaluate on one PNG tile, then inpaint_directory end to end
     on a directory of 512^2 PNGs;
  8. train: the port's train() for one epoch over 24 PNG tiles at batch
     8 (3 steps of G+D with the full loss, VGG perceptual included) and
     one validation batch of 8, with seeded G, D and VGG, fp32, TF32
     off; the launch counts (K1 forward and backward 7 per step, K2's
     train variant 14 and the pack 1 per step, K2 and K3 only in
     validation), the best checkpoint reloaded strictly into
     a fresh state, ms per step, samples/s and peak memory; then
     Big-LaMa (seeded G, D and VGG): one GAN step of make_train_step at
     batch 2 and evaluate on one PNG tile, each launching ffc_local 36
     times (once a block FFC), counted from 0, and the GAN step
     ffc_local_dgrad and ffc_local_wgrad 36 times each, evaluate none;
  9. train_grad: one batch of 8 through the G objective's forward and
     backward, once through the kernels (K1, K2's train variant) and once
     with torch's own upsample in K1's place (K2's train stages in both),
     cuDNN deterministic: the gradient at dec1's upsample input and the
     per-block weight gradients held to one bound, which the second run
     in TF32 must exceed; beside them, information, the same readings of
     the plain path (torch's upsample, the plain partial conv);
 10. k3: K3 fused_decoder_tail against its plain version on the
     full-width model's own dec2 features and masks at batch 2, 512^2,
     in the model's one-input form and with a seeded k_skip (the JAX
     form), with the model's tail weights and with seeded tail weights
     whose logits spread over units (features at unit RMS, xm = 0);
     there the plain tail run in TF32 must fail the same bound; two calls
     bitwise equal. Times of K3, its plain version and the unfused kernel
     path (K1 + K2 dec1 + cuDNN's final conv + composite), and its bound
     at the 3xTF32 rate for dec1 and fp32 for the final conv;
 11. serve: the port's HTTP server in a thread on 127.0.0.1 with the
     full-width 512^2 model, max_batch 8 and an auth secret; through
     the port's client 16 concurrent /inpaint requests and one
     /inpaint_batch of 4, /healthz, /stats, /metrics and a 401; every
     response within 1 grey level of BatchedInpainter's output with the
     unfused tail, and 1 K3, 13 K2 and 6 K1 launches a forward;
 12. probes: the five probe kernels P1-P5 (csrc/probes.cu) against their
     plain versions at scripts/probe_mosaic.py's shapes and seed (P4 and
     P5 equal, P1-P3 within 1e-6 of max|plain|), P1-P5 in each of
     their two variants (vec4 and scalar, forced through plan_probe) and
     as planned on a view at a 4-byte offset (scalar), and against numpy
     as cli/probe_cuda.py prints it. Times: each kernel (and each
     variant), its plain version, its library call (P3 has none; beside
     it torch.matmul on the pre-built [a, 2a], the product alone) and an
     empty launch on the device by
     graph replay (graph_device_ms: 1000 calls captured in one CUDA
     graph, which must hold one kernel node a probe call, the median of
     5 timed replays over 1000), beside the per-call CUDA-event time
     (the host's launch) and torch.profiler's device time, which reads
     "unresolved" where the profiler recorded fewer device events than
     launches;
 13. doctor: ``doctor.main([])`` exits 0 with backend, kernel-build,
     model and probes PASS and all five probes OK;
 14. cli: the pipeline CLI's evaluate mode in-process (config read by
     yaml_lite, 2 parent grids of 8 512^2 PNG tiles, a master checkpoint
     of the seeded full-width model): exit 0, every inpainted PNG within
     1 grey level of inpaint_directory with the unfused tail, every
     colored PNG the LUT of its inpainted one, 13 K2 (1 one-channel, 0
     SIMT), 6 K1, 1 K3 and 1 pack launches a forward; ``--mesh``, not
     ported, exits 2;
 15. train_mode: the CLI's ``--mode train`` in-process on a synthetic
     Digimap parent zip (scripts/bench_ingest.py's tiles, seed 7: 4x4
     children, DSM 500^2 .asc, RGB 2000^2 JPEG with green patches,
     diagonal and near-axis roads, furrowed fields and texture), from a
     seeded full-width master given as --input_model, batch 8, one
     epoch, fp32, the full loss with the port's seeded VGG: exit 0, 16
     raw PNGs and masks, the checkerboard's split metadata, the master
     checkpoint (reloaded strictly, at step 1), its timestamped copy and
     the metrics JSON with finite losses; 7 K1 fwd and bwd, 14 K2 train
     stages and 1 pack a train step, 13 K2 (1 one-channel, 0 SIMT), 6 K1, 1 K3 and 1 pack a validation
     forward; each detector's call on every tile of that run's ingest
     (every road, vegetation and field mask non-empty); no error logged
     by the port. Then, at every batch size that run and the drill give
     the kernels (5, and the drill's 3 and 2), the validation forward
     with the master's weights on ingested tiles against the plain path
     (NRMSE 1e-5 on the composite, 1e-6 on dec2's features), K2 at the
     14 stages (1e-4 of the max) and K1 fwd (equal) and bwd (1e-6 of the
     max) at the 7 upsample shapes. The drill: the same command at batch
     3 (two train batches) with TERRA_GAN_TPU_FAULT=preempt@0:1 exits 75
     leaving preempted.pth with a trained state at step 1, and run again
     resumes from it (its master's step counts the preempted state's
     step) and removes it. Figures: the ingest's tiles/s (from the CLI
     run's log, min(8, cores) threads), each detector's ms a tile in that
     ingest, the detectors on one tile on the card against the same
     detectors on the CPU (equal masks, or a combined-mask IoU of 0.999,
     differing pixels counted), one 4000^2 tile (Digimap's native size)
     by detector, and the train step at batch 8 on ingested tiles (ms,
     samples/s, peak memory), each beside the card's name and power
     limit;
 16. human_guided: the port's portal server in a thread on 127.0.0.1
     with a JWT secret; a grid's 7 test tiles at 512^2 uploaded through
     ``upload_results`` (the port's client) and one annotation a tile
     posted to /save_annotation as the annotator's page posts it (the
     page and its script served from the port's static files); then
     the CLI's ``--mode human_guided_train`` in-process under
     EXPERIMENT_MODE from a seeded full-width master, batch 5 (batches
     of 5 and 2), 2 epochs, the full loss with the port's seeded VGG:
     exit 0, the annotations fetched and matched, the human-guided master
     (its keys, reloaded strictly, weights moved, BatchNorm at the run's
     4 steps) and its stamped copy, the portal's annotations deleted; 7
     K1 fwd and 7 K1 bwd, 14 K2 train stages and 1 pack a step and no
     eval K2 or K3. One HG step's gradients through the kernels (K1, K2's
     train variant) against torch's upsample in K1's place at the train_grad
     phase's bound (the torch-upsample run in TF32 must exceed it); K1 fwd
     (equal) and bwd (1e-6 of the max) at batches 5 and 2 on the 7
     shapes; the HG step at batch 5 (ms, samples/s, peak memory), the
     fetch's seconds and files, the epoch losses; the drill:
     TERRA_GAN_TPU_FAULT=preempt@0:1 on a one-epoch config exits 75 with
     preempted.pth after one step, and run again resumes from it (its
     master one epoch further) and removes it.
Then a JSON line of per-kernel figures (each with its bound: the larger
of its bytes over 3.35 TB/s and its operations over the peak of the
unit it runs on, from this run's shapes: the 67 TFLOP/s of fp32 outside
the tensor cores, or for K2's MMA stages and K3's dec1 495 TFLOP/s of
dense TF32 over the 3 TF32 products of each fp32 product; a probe's ms,
plain_ms and library_ms are device times a launch by graph replay, K1's
the same summed over its 7 shapes at batch 2 (and at 8, and the largest
shape, beside them), and K2's and P1-P4's launches are also given by
variant, K2's with enc1's graph-replay figures), and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without CUDA it exits nonzero before printing any result.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import ctypes
import io
import itertools
import json
import logging
import math
import os
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
from wsgiref.simple_server import WSGIRequestHandler
from wsgiref.simple_server import make_server as make_wsgi_server

import numpy as np
import torch
import torch.nn.functional as F

from terra_gan_tpu_torch.cli import doctor, main_pipeline
from terra_gan_tpu_torch.cli.probe_cuda import probe_cases, probe_inputs, run_probes
from terra_gan_tpu_torch.data.visualization import build_lut
from terra_gan_tpu_torch.evaluation.inference import OUTPUT_SIZE, evaluate, inpaint_directory
from terra_gan_tpu_torch.models.generator import STAGES
from terra_gan_tpu_torch.ops.cuda._build import build_info, check, find_nvcc, load_library
from terra_gan_tpu_torch.ops.cuda.probe_kernels import (
    PLAIN,
    PROBES,
    VARIANTS,
    empty_launch,
    plan_probe,
    probe_row_build,
)
from terra_gan_tpu_torch.ops.cuda.pconv_kernel import (
    MMA_TILES,
    fold_batch_norm,
    fused_pconv_eval,
    fused_pconv_eval_plain,
    fused_pconv_train,
    fused_pconv_train_plain,
    pack_pconv_weight,
    pack_pconv_weights,
    plan_stage,
    sm_count,
)
from terra_gan_tpu_torch.config import Config, LoopConfig
from terra_gan_tpu_torch.data.asc import write_asc
from terra_gan_tpu_torch.data.dataset import DirectMatchDataset, InpaintingDataset
from terra_gan_tpu_torch.data.mask_processing import MaskPipeline, MaskType
from terra_gan_tpu_torch.data.mask_processing.detectors import (
    BuildingDetector,
    FieldDetector,
    RoadDetector,
    VegetationDetector,
)
from terra_gan_tpu_torch.data.mask_processing.pipeline import read_bgr
from terra_gan_tpu_torch.data.splitting import checkerboard_split
from terra_gan_tpu_torch.ops.cuda.upsample_kernel import (
    upsample2x_bwd,
    upsample2x_bwd_plain,
    upsample2x_fwd,
    upsample2x_fwd_plain,
)
from terra_gan_tpu_torch.ops.cuda.tail_kernel import fused_decoder_tail, fused_decoder_tail_plain
from terra_gan_tpu_torch.ops.cuda.ffc_kernel import (
    WGRAD_PIXELS,
    WGRAD_TILE,
    WGRAD_TILE_SUMS,
    ffc_local,
    ffc_local_backward_plain,
    ffc_local_dgrad,
    ffc_local_dgrad_plain,
    ffc_local_plain,
    ffc_local_wgrad,
    ffc_local_wgrad_plain,
)
from terra_gan_tpu_torch.ops.resize import upsample2x_bilinear
from terra_gan_tpu_torch.parallel.infer import BatchedInpainter
from terra_gan_tpu_torch.losses import human_guided_loss
from terra_gan_tpu_torch.portal import (
    PortalClient,
    jwt_auth,
    match_human_and_system_masks,
    upload_results,
)
from terra_gan_tpu_torch.portal.server import STATIC_DIR as PORTAL_STATIC
from terra_gan_tpu_torch.portal.server import create_app as create_portal_app
from terra_gan_tpu_torch.serving import InpaintClient, InpaintService, make_server
from terra_gan_tpu_torch.training.checkpoint import export_pth, import_pth
from terra_gan_tpu_torch.training.human_guided import HumanGuidedTrainer, hg_loss_config
from terra_gan_tpu_torch.training.loop import FAULT_ENV, train
from terra_gan_tpu_torch.training.state import GANTrainState, adam
from terra_gan_tpu_torch.training.step import generator_objective, make_train_step
from terra_gan_tpu_torch.utils import yaml_lite
from terra_gan_tpu_torch.utils.weights import (
    init_discriminator,
    init_generator,
    init_vgg,
    load_generator,
)

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
# against the same forward with torch's upsample in K1's place, both at the
# upsample input and per block. With K1 fwd at torch's bits and K2's train
# stages on both sides the two differ only in the backward's fp32 sum order
# (K1 bwd gathers, torch adds with atomics), and torch's plain path against
# itself already reads 9e-8 at the upsample input and 1.5e-6 a block; the
# plain path in TF32 reads 7e-2 and 5e-2. (K2's forward in place of cuDNN's
# moves them by fp32 sums in another order: 8.9e-4 and 2.6e-4 on an H100.)
GRAD_TOL = 1e-5
# K3 against its plain version, NRMSE of the composite: fp32 sums in
# another order; the plain tail in TF32 must exceed it on the spread weights
K3_NRMSE_TOL = 1e-5
# K2's train forward at the training cells' batches: the human-guided
# step's 5 and the GAN step's 32 and its epoch's last 16
K2_TRAIN_BATCHES = (5, 16, 32)
# its output (before BatchNorm) against the plain partial conv: fp32 sums in another order
K2_TRAIN_NRMSE_TOL = 1e-5
# The block FFC's local and cross convolutions (ffc_local) at Big-LaMa's
# block shapes, 64^2, 128 local and 384 global channels, at the LaMa
# training cell's batch 16, the eval path's chunk 8 and the fine-tune's 5
FFC_BATCHES = (16, 8, 5)
FFC_SIDE, FFC_LOCAL, FFC_GLOBAL = 64, 128, 384
# NRMSE against the plain version in float64: 3xTF32 products summed in
# fp32 read about 1e-7; the plain version in TF32 must exceed it
FFC_NRMSE_TOL = 1e-6
# (batch, local, global channels, H, W) beside the block's
FFC_OTHER_SHAPES = ((2, 8, 24, 13, 14), (2, 12, 20, 5, 70), (3, 132, 388, 32, 130),
                    (1, 4, 4, 2, 2))
# FFCLocal's gradients against autograd through the plain version in
# float64, rel L2 of the worst of the six: the backward's kernels, 3xTF32
# products summed in fp32 over 4,608 taps (the inputs') and 65,536 pixels
# (the weights'), in chunks added in IEEE order; cuDNN's fp32 beside them
FFC_GRAD_TOL = 1e-5
# the backward's kernels against their plain versions in float64, NRMSE
# (csrc/ffc_conv.cu's note): 3xTF32 sums in fp32 read about 1e-7, the
# plain versions in TF32 must exceed it
FFC_BWD_NRMSE_TOL = 1e-6
SERVE_REQUESTS, SERVE_BATCH_ITEMS, SERVE_MAX_BATCH = 16, 4, 8
SERVE_SECRET = "chip-smoke-secret"
# K1 is timed at the batch of the other kernels and at the profile's 8
K1_BATCHES = (STAGE_BATCH, 8)
# enc1 by graph replay at the batch of the other kernels and at the profile's 8
ENC1_BATCHES = (STAGE_BATCH, 8)
# P1-P3 against their plain versions, of max|plain|: fp32 sums in another
# order (sums of 64 and 128 products); P4 and P5 round as torch does: equal
PROBE_SUM_REL_TOL = 1e-6
# device time per launch by graph replay: calls captured in one graph, timed replays
GRAPH_LAUNCHES, GRAPH_REPLAYS = 1000, 5
# where GRAPH_LAUNCHES calls would take longer, fewer: a replay of about this many ms
GRAPH_MIN_MS = 20.0
# the H100's L2: K1's graph calls rotate over as many inputs and outputs as
# pass twice this, so that each call reads its input from device memory
L2_BYTES = 50 * 2**20
CLI_GRIDS, CLI_TILES = ("NJ05", "SU12"), 8
# scripts/probe_mosaic.py's lines of the probes the kernels replace
PROBE_REPLACES = {"probe_lane_reduce": 45, "probe_matvec_dot": 66, "probe_lane_concat_dot": 91,
                  "probe_mask_broadcast": 117, "probe_row_build": 138}
# the card's peaks (NVIDIA's H100 SXM data sheet): fp32 outside the tensor
# cores, dense TF32 on them, and device memory; a kernel's bound is the
# larger of its two times. K2's MMA variant and K3's dec1 make each fp32
# product of 3 TF32 products (3xTF32), so they run at a third of the TF32 rate.
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
TF32X3_FLOPS = TF32_FLOPS / 3
HBM_BYTES_PER_S = 3.35e12
PEAKS = {"fp32": "fp32 outside the tensor cores, 67 TFLOP/s",
         "k2": "3xTF32: 3 TF32 products per fp32 product at 495 TFLOP/s (165 TFLOP/s of fp32 "
               "products), every stage (enc1's one-channel variant too)",
         "k3": "3xTF32 for dec1 (165 TFLOP/s of fp32 products), counted once, not the "
               "recomputed halo; 67 TFLOP/s fp32 for the final conv and the skip term",
         "ffc": "3xTF32: 3 TF32 products per fp32 product at 495 TFLOP/s (165 TFLOP/s of fp32 "
                "products), the three convolutions; the sums and the pack not counted"}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def line(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def reset_counts(counters) -> None:
    """Every kernel's launch count (and K2's counts by variant) to 0."""
    for fn in counters:
        fn.launches = 0
        if hasattr(fn, "variants"):
            fn.variants = dict.fromkeys(fn.variants, 0)


def read_counts(counters) -> dict:
    """{kernel: launches}, and K2's launches by variant as "kernel.variant"."""
    out = {fn.__name__: fn.launches for fn in counters}
    for fn in counters:
        out.update({f"{fn.__name__}.{v}": n for v, n in getattr(fn, "variants", {}).items()})
    return out


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


def host_ms(fn, reps: int = REPS) -> float:
    """Median host time of one call on an idle card: the wrapper's own cost
    (checks, allocation, the launch), since the kernel runs asynchronously."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(flop: float, nbytes: float, peak: float = FP32_FLOPS) -> dict:
    """The least time the card could take for the work at the unit's
    ``peak`` FLOP/s, and what bounds it."""
    t_ops, t_bytes = flop / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
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


def kernel_report(info) -> dict:
    """Per kernel of the built library (mangled name): registers, spilled
    bytes and static shared memory from ptxas's report, and the count of
    tensor-core instructions (HMMA, HGMMA) in its SASS (cuobjdump -sass)."""
    report, fn = {}, None
    for ln in str(info["log"]).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", ln)
        if m:
            fn = m.group(1)
            report.setdefault(fn, {})
        elif fn and "spill stores" in ln:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln).groups()
            report[fn]["spill_bytes"] = int(st) + int(ld)
        elif fn and "Used" in ln and "registers" in ln:
            report[fn]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            report[fn]["smem"] = int(smem.group(1)) if smem else 0
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", info["path"]], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    fn = None
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            report.setdefault(fn, {}).update(hmma=0, hgmma=0)
        elif fn and "HGMMA" in ln:
            report[fn]["hgmma"] += 1
        elif fn and "HMMA" in ln:
            report[fn]["hmma"] += 1
    return report


def phase_build():
    lib = load_library()
    info = build_info()
    line("build", built=info["built"], seconds=f"{info['seconds']:.1f}",
         sources=",".join(info["sources"]), flags=repr(" ".join(info["flags"])),
         lib=info["path"])
    report = kernel_report(info)
    for fn, r in sorted(report.items()):
        line("build", kernel=fn, registers=r.get("registers"), spill_bytes=r.get("spill_bytes"),
             static_smem=r.get("smem"), hmma=r.get("hmma"), hgmma=r.get("hgmma"))
    for tile, (bm, bn) in enumerate(MMA_TILES):
        line("build", k2_mma_tile=f"{bm}x{bn}", dynamic_smem_k3=lib.tg_pconv_mma_smem_bytes(tile, 3),
             dynamic_smem_k5=lib.tg_pconv_mma_smem_bytes(tile, 5))
    k2 = {fn: r for fn, r in report.items() if "pconv" in fn or "pack_tf32" in fn}
    mma = [r for fn, r in k2.items() if "pconv_mma_kernel" in fn]
    require(len(mma) == len(MMA_TILES) and all(r.get("hmma", 0) + r.get("hgmma", 0) > 0
                                               for r in mma),
            f"build: K2's MMA kernels show no tensor-core instructions: {k2}")
    require(all(r.get("spill_bytes") == 0 for r in k2.values()), f"build: a K2 kernel spills: {k2}")
    c1 = {fn: r for fn, r in k2.items() if "pconv_c1_kernel" in fn}
    smem, blocks, threads, th, tw = (ctypes.c_int() for _ in range(5))
    check(lib.tg_pconv_c1_info(*(ctypes.byref(v) for v in (smem, blocks, threads, th, tw))),
          "tg_pconv_c1_info")
    for fn, r in c1.items():
        line("build", k2_c1_kernel=fn, registers=r.get("registers"),
             spill_bytes=r.get("spill_bytes"), hmma=r.get("hmma"), hgmma=r.get("hgmma"),
             dynamic_smem=smem.value, blocks_per_sm=blocks.value, threads=threads.value,
             output_tile=f"{th.value}x{tw.value}")
    require(len(c1) == 1 and all(r.get("hmma", 0) > 0 for r in c1.values()) and blocks.value >= 2,
            f"build: K2's one-channel kernel is not one with HMMA at 2 blocks an SM: {c1}, "
            f"{blocks.value} blocks an SM")
    # the train forward's instantiations: the MMA tiles and the one-channel kernel
    train = {fn: r for fn, r in k2.items() if "_train_kernel" in fn}
    for fn, r in sorted(train.items()):
        line("build", k2_train_kernel=fn, registers=r.get("registers"),
             spill_bytes=r.get("spill_bytes"), hmma=r.get("hmma"))
    tensor_core = [r for fn, r in train.items() if "mma_train" in fn or "c1_train" in fn]
    require(len(train) == 5 and len(tensor_core) == 3
            and all(r.get("hmma", 0) > 0 for r in tensor_core),
            f"build: K2's train kernels are not 5 (3 with HMMA): {train}")
    smem, blocks, threads, tile = (ctypes.c_int() for _ in range(4))
    check(lib.tg_decoder_tail_info(*(ctypes.byref(v) for v in (smem, blocks, threads, tile))),
          "tg_decoder_tail_info")
    k3 = {fn: r for fn, r in report.items() if "decoder_tail" in fn}
    for fn, r in k3.items():
        line("build", k3_kernel=fn, registers=r.get("registers"), spill_bytes=r.get("spill_bytes"),
             dynamic_smem=smem.value, blocks_per_sm=blocks.value, threads=threads.value,
             output_tile=f"{tile.value}x{tile.value}", hmma=r.get("hmma"), hgmma=r.get("hgmma"))
    require(len(k3) == 1 and all(r.get("hmma", 0) > 0 for r in k3.values()),
            f"build: K3 shows no tensor-core instructions: {k3}")
    require(all(r.get("spill_bytes") == 0 for r in k3.values()), f"build: K3 spills: {k3}")
    ffc = {fn: r for fn, r in report.items() if "ffc_local_kernel" in fn}
    smem, threads, rows, cols, chans = (ctypes.c_int() for _ in range(5))
    check(lib.tg_ffc_local_info(*(ctypes.byref(v) for v in (smem, threads, rows, cols, chans))),
          "tg_ffc_local_info")
    for fn, r in sorted(ffc.items()):
        line("build", ffc_kernel=fn, registers=r.get("registers"), spill_bytes=r.get("spill_bytes"),
             dynamic_smem=smem.value, threads=threads.value,
             tile=f"{rows.value}x{cols.value}x{chans.value}", hmma=r.get("hmma"),
             hgmma=r.get("hgmma"))
    require(len(ffc) == 2 and all(r.get("hmma", 0) > 0 and r.get("spill_bytes") == 0
                                  for r in ffc.values()),
            f"build: the FFC kernels are not 2 with HMMA and without spills: {ffc}")
    # the backward's: dgrad and wgrad (each at W % 4 == 0 and not) with HMMA,
    # the frame, border, fold and reduction kernels; none spills
    bwd = {fn: r for fn, r in report.items()
           if re.search(r"ffc_(dgrad|wgrad)(_frame|_border|_fold|_reduce)?_kernel", fn)}
    smem, threads, tile_n, tile_c, pixels, sums = (ctypes.c_int() for _ in range(6))
    check(lib.tg_ffc_wgrad_info(*(ctypes.byref(v) for v in (smem, threads, tile_n, tile_c, pixels,
                                                            sums))), "tg_ffc_wgrad_info")
    for fn, r in sorted(bwd.items()):
        line("build", ffc_bwd_kernel=fn, registers=r.get("registers"),
             spill_bytes=r.get("spill_bytes"), hmma=r.get("hmma"), hgmma=r.get("hgmma"))
    line("build", ffc_wgrad_smem=smem.value, threads=threads.value,
         job=f"{tile_n.value}x{tile_c.value}x9", pixels=pixels.value, sums=sums.value)
    mma_bwd = [r for fn, r in bwd.items() if re.search(r"ffc_(dgrad|wgrad)_kernel", fn)]
    require(len(bwd) == 8 and len(mma_bwd) == 4 and all(r.get("hmma", 0) > 0 for r in mma_bwd)
            and all(r.get("spill_bytes") == 0 for r in bwd.values()),
            f"build: the FFC backward's kernels are not 8 (4 with HMMA) without spills: {bwd}")
    require((tile_n.value, tile_c.value) == WGRAD_TILE and pixels.value == WGRAD_PIXELS
            and sums.value == WGRAD_TILE_SUMS,
            f"build: the wgrad kernel's tile {tile_n.value}x{tile_c.value}, {pixels.value} "
            f"pixels, {sums.value} sums; the wrapper's {WGRAD_TILE}, {WGRAD_PIXELS}, "
            f"{WGRAD_TILE_SUMS}")
    # P1's and P2's 6 lane counts (one kernel for both) and P4, each in two variants
    p2p4 = {fn: r for fn, r in report.items()
            if "matvec_dot_kernel" in fn or "mask_broadcast_kernel" in fn}
    require(len(p2p4) == 14 and all(r.get("spill_bytes") == 0 for r in p2p4.values()),
            f"build: P1's, P2's and P4's kernels are not 14 without spills: {p2p4}")
    p3 = {fn: r for fn, r in report.items() if "lane_concat_dot_kernel" in fn}
    for fn, r in sorted(p2p4.items()):
        if "matvec_dot_kernel" in fn:
            line("build", p1_kernel=fn, registers=r.get("registers"),
                 spill_bytes=r.get("spill_bytes"))
    for fn, r in sorted(p3.items()):
        line("build", p3_kernel=fn, registers=r.get("registers"), spill_bytes=r.get("spill_bytes"))
    require(len(p3) == 2 and all(r.get("spill_bytes") == 0 and r.get("registers", 255) <= 64
                                 for r in p3.values()),
            f"build: P3's kernels are not 2 within 64 registers without spills: {p3}")
    p5 = {fn: r for fn, r in report.items() if "row_build_kernel" in fn}
    for fn, r in sorted(p5.items()):
        line("build", p5_kernel=fn, registers=r.get("registers"), spill_bytes=r.get("spill_bytes"))
    require(len(p5) == 2 and all(r.get("spill_bytes") == 0 for r in p5.values()),
            f"build: P5's kernels are not 2 without spills: {p5}")
    # K1: the forward in fp32 and bf16, the adjoint in each at 1 and 2 dx rows a thread
    k1 = {fn: r for fn, r in report.items() if "upsample2x_" in fn and "_kernel" in fn}
    for fn, r in sorted(k1.items()):
        line("build", k1_kernel=fn, registers=r.get("registers"), spill_bytes=r.get("spill_bytes"))
    require(len(k1) == 6 and all(r.get("spill_bytes") == 0 for r in k1.values()),
            f"build: K1's kernels are not 6 without spills: {k1}")


def stage_inputs(st, h: int, ca: int, cb: int, batch: int, gen, dev):
    """Seeded inputs of one stage, with the model's weights and cached planes."""
    x = torch.rand((batch, h, h, ca), generator=gen).to(dev)
    xs = torch.rand((batch, h, h, cb), generator=gen).to(dev) if cb else None
    m = holey_mask(batch, h, h, gen, dev)
    weight, bias = st.input_conv.weight.detach(), st.input_conv.bias.detach()
    a, bb = fold_batch_norm(st.bn.weight.detach(), st.bn.bias.detach(),
                            st.bn.running_mean, st.bn.running_var, st.bn.eps)
    return (x, m, weight, bias, st.stride, st.padding, a, bb), xs, st.packed_weight()


def k2_stage(args, xs, packed, reps: int = REPS) -> dict:
    """One K2 stage measured against its plain version and its yardstick,
    one cuDNN fp32 conv of the same masked input (channels_last, TF32
    off): the variant, tile and splits of its plan, the error, bitwise
    reproducibility, times, the wrapper's host time a call, TFLOP/s and
    the bound at its unit's peak."""
    x, m, weight, bias, stride, padding = args[:6]
    got, got_m = fused_pconv_eval(*args, x_skip=xs, packed=packed)
    again, again_m = fused_pconv_eval(*args, x_skip=xs, packed=packed)
    want, want_m = fused_pconv_eval_plain(*args, x_skip=xs)
    xm = (x if xs is None else torch.cat([x, xs], -1)) * m
    xm_cl = xm.permute(0, 3, 1, 2)  # NCHW in channels_last memory
    w_cl = weight.contiguous(memory_format=torch.channels_last)
    torch.cuda.synchronize()
    t_k = time_ms(lambda: fused_pconv_eval(*args, x_skip=xs, packed=packed), reps)
    t_p = time_ms(lambda: fused_pconv_eval_plain(*args, x_skip=xs), reps)
    t_l = time_ms(lambda: F.conv2d(xm_cl, w_cl, bias, stride, padding), reps)
    t_h = host_ms(lambda: fused_pconv_eval(*args, x_skip=xs, packed=packed), reps)
    b, oh, ow, cout = got.shape
    plan = plan_stage(b * oh * ow, cout, x.shape[-1], 0 if xs is None else xs.shape[-1],
                      weight.shape[-1], sm_count(x.device))
    flop = 2.0 * got.numel() * weight[0].numel()
    peak = FP32_FLOPS if plan.variant == "simt" else TF32X3_FLOPS
    err = (got - want).abs().max().item()
    return dict(variant=plan.variant, splits=plan.splits,
                tile="-" if plan.tile < 0 else "x".join(map(str, MMA_TILES[plan.tile])),
                max_abs_err=err, scale=want.abs().max().item(),
                masks_equal=torch.equal(got_m, want_m), holes=int((want_m == 0).sum()),
                bitwise=torch.equal(got, again) and torch.equal(got_m, again_m),
                finite=torch.isfinite(got).all().item(), out="x".join(map(str, got.shape)),
                ms=t_k, plain_ms=t_p, library_ms=t_l, host_ms=t_h, flop=flop,
                tflops=flop / t_k / 1e9,
                **bound(flop, nbytes(x, xs, m, weight, bias, *args[6:], got, got_m), peak))


def sum_bounds(rows) -> dict:
    """The bound of a sequence of stages: the sum of theirs, bound by what
    bounds the larger share of it."""
    total = sum(r["bound_ms"] for r in rows)
    ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    return {"bound_ms": total, "bound_by": "operations" if 2 * ops >= total else "bytes"}


def phase_k2(model, dev):
    gen = torch.Generator().manual_seed(SEED + 1)
    rows = []
    for name, h, ca, cb, st in stage_geometries(model, SIZE):
        args, xs, packed = stage_inputs(st, h, ca, cb, STAGE_BATCH, gen, dev)
        r = k2_stage(args, xs, packed)
        rel = r["max_abs_err"] / max(r["scale"], 1e-30)
        line("k2", stage=name, x=f"{STAGE_BATCH}x{h}x{h}x{ca}+{cb}", out=r["out"],
             k=st.input_conv.kernel_size[0], s=st.stride, variant=r["variant"], tile=r["tile"],
             splits=r["splits"], max_abs_err=f"{r['max_abs_err']:.3e}", rel=f"{rel:.3e}",
             masks_equal=r["masks_equal"], bitwise=r["bitwise"], holes=r["holes"],
             ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
             library_ms=f"{r['library_ms']:.4f}", host_ms=f"{r['host_ms']:.4f}",
             tflops=f"{r['tflops']:.2f}", bound_ms=f"{r['bound_ms']:.4f}",
             bound_by=r["bound_by"])
        require(r["finite"], f"K2 {name}: non-finite output")
        require(r["max_abs_err"] <= K2_REL_TOL * r["scale"],
                f"K2 {name}: err {r['max_abs_err']} > {K2_REL_TOL} * {r['scale']}")
        require(r["masks_equal"], f"K2 {name}: new_mask differs from the plain version")
        require(r["bitwise"], f"K2 {name}: two calls on the same inputs differ")
        rows.append(r)
    fig = dict(max_abs_err=max(r["max_abs_err"] for r in rows),
               ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
               library_ms=sum(r["library_ms"] for r in rows), **sum_bounds(rows))
    flop = sum(r["flop"] for r in rows)
    line("k2", stages=len(rows), ms=f"{fig['ms']:.4f}", plain_ms=f"{fig['plain_ms']:.4f}",
         library_ms=f"{fig['library_ms']:.4f}", gflop=f"{flop / 1e9:.2f}",
         tflops=f"{flop / fig['ms'] / 1e9:.2f}", bound_ms=f"{fig['bound_ms']:.4f}",
         bound_by=fig["bound_by"], vs_bound=f"{fig['ms'] / fig['bound_ms']:.2f}")
    empty = timed_on_device("the empty launch", lambda: empty_launch(dev), kernels=1)
    fig["enc1"] = {"variant": rows[0]["variant"], "empty_ms": empty,
                   "timing": "device ms a call by CUDA graph replay, inputs rotated past the L2"}
    for batch in ENC1_BATCHES:
        args, _, packed = stage_inputs(model.enc1, SIZE, 1, 0, batch, gen, dev)
        r = enc1_times(args, packed)
        del args, packed
        fig["enc1"][f"batch{batch}"] = r
        line("k2_enc1", batch=batch, variant=rows[0]["variant"], ms=f"{r['ms']:.5f}",
             plain_ms=f"{r['plain_ms']:.5f}", library_ms=f"{r['library_ms']:.5f}",
             simt_ms=f"{r['simt_ms']:.5f}", empty_ms=f"{empty:.5f}",
             bound_ms=f"{r['bound_ms']:.5f}", bound_by=r["bound_by"],
             vs_bound=f"{r['ms'] / r['bound_ms']:.3f}", tflops=f"{r['tflops']:.2f}",
             host_ms=f"{r['host_ms']:.4f}", calls=r["calls"], copies=r["copies"],
             max_abs_err=f"{r['max_abs_err']:.3e}", simt_max_abs_err=f"{r['simt_max_abs_err']:.3e}",
             simt_masks_equal=r["simt_masks_equal"])
        require(r["max_abs_err"] <= K2_REL_TOL * r["scale"] and r["masks_equal"],
                f"K2 enc1 at batch {batch}: err {r['max_abs_err']} of {r['scale']}, "
                f"masks equal {r['masks_equal']}")
        # the SIMT kernel, which the plan still gives the other ragged channel counts
        require(r["simt_max_abs_err"] <= K2_REL_TOL * r["scale"] and r["simt_masks_equal"],
                f"K2 SIMT on enc1 at batch {batch}: err {r['simt_max_abs_err']} of {r['scale']}, "
                f"masks equal {r['simt_masks_equal']}")
    return fig


def simt_enc1(args, out_shape, lib=None):
    """enc1 on the SIMT kernel it ran on before the one-channel variant
    (tg_pconv_eval_f32 of ``lib``, by default the port's, where it is still
    built for other channel counts): HWIO weights copied once, then the C
    entry called as its wrapper called it; a call of (x, mask)."""
    x, m, weight, bias, stride, padding, a, bb = args
    b, h, w, _ = x.shape
    cout, k = weight.shape[0], weight.shape[-1]
    hwio = weight.permute(2, 3, 1, 0).contiguous()
    lib = lib or load_library()
    # the eval epilogue (train = 0); a build from before the train flag takes none
    train = (0,) * (len(lib.tg_pconv_eval_f32.argtypes) - 19)

    def call(xm):
        out = torch.empty(out_shape, device=x.device)
        new_mask = torch.empty((*out_shape[:3], 1), device=x.device)
        check(lib.tg_pconv_eval_f32(xm[0].data_ptr(), None, xm[1].data_ptr(), hwio.data_ptr(),
                                    bias.data_ptr(), a.data_ptr(), bb.data_ptr(), out.data_ptr(),
                                    new_mask.data_ptr(), b, h, w, 1, 0, cout, k, stride, padding,
                                    *train, torch.cuda.current_stream().cuda_stream), "simt_enc1")
        return out, new_mask
    return call


def enc1_times(args, packed, versions=None) -> dict:
    """enc1 (a stage_inputs of it) on the device by graph replay: the
    kernel as the forward calls it (its planes packed beforehand; one
    kernel node a call), its plain version, the SIMT kernel and cuDNN's
    fp32 conv alone of the same masked input, each with calls a graph
    scaled to a replay of about GRAPH_MIN_MS and rotated over copies of
    (x, mask) past the L2; the bound at 3xTF32's rate; the wrapper's host
    ms a call. ``versions``: more {name: (call of (x, mask), kernel nodes a
    call or None)} timed the same way after the SIMT kernel
    (profile_slice.py's turns)."""
    x, m, weight, bias, stride, padding, a, bb = args
    got, got_m = fused_pconv_eval(*args, packed=packed)
    want, want_m = fused_pconv_eval_plain(*args)
    simt = simt_enc1(args, tuple(got.shape))
    simt_out, simt_m = simt((x, m))
    torch.cuda.synchronize()
    flop = 2.0 * got.numel() * weight[0].numel()
    fig = bound(flop, nbytes(x, m, *packed, bias, a, bb, got, got_m), TF32X3_FLOPS)
    calls = graph_calls(fig["bound_ms"])
    srcs = past_l2((x, m), nbytes(got, got_m), calls)
    kernel = lambda xm: fused_pconv_eval(xm[0], xm[1], *args[2:], packed=packed)  # noqa: E731
    plain = lambda xm: fused_pconv_eval_plain(xm[0], xm[1], *args[2:])  # noqa: E731
    w_cl = weight.contiguous(memory_format=torch.channels_last)
    conv_srcs = [((v[0] * v[1]).permute(0, 3, 1, 2),) for v in srcs]  # x * m, NCHW views
    conv = lambda v: F.conv2d(v[0], w_cl, bias, stride, padding)  # noqa: E731
    versions = {"ms": (kernel, 1), "plain_ms": (plain, None), "simt_ms": (simt, 1),
                **(versions or {})}
    times = {name: timed_on_device(f"K2 enc1 {name}", rotating(fn, srcs), kernels=kernels,
                                   launches=calls)
             for name, (fn, kernels) in versions.items()}
    times["library_ms"] = timed_on_device("K2 enc1's conv alone", rotating(conv, conv_srcs),
                                          launches=calls)
    return dict(**times, host_ms=host_ms(lambda: kernel((x, m))), calls=calls, copies=len(srcs),
                max_abs_err=(got - want).abs().max().item(), scale=want.abs().max().item(),
                simt_max_abs_err=(simt_out - want).abs().max().item(),
                simt_masks_equal=torch.equal(simt_m, want_m),
                masks_equal=torch.equal(got_m, want_m), flop=flop, tflops=flop / times["ms"] / 1e9,
                **fig)


def phase_k2_train(model, dev):
    """K2's train forward (``fused_pconv_train``: the partial conv before
    BatchNorm) against its plain version at the 14 stages at each of
    K2_TRAIN_BATCHES, forward alone: the error, new_mask, and the times of
    K2 and of the plain stage with cuDNN's heuristic (its search off, as
    the port trains) and with its search on (the yardstick)."""
    gen = torch.Generator().manual_seed(SEED + 50)
    flags = torch.backends.cudnn.benchmark
    totals, worst = {}, 0.0
    for batch in K2_TRAIN_BATCHES:
        rows = []
        for name, h, ca, cb, st in stage_geometries(model, SIZE):
            args, xs, packed = stage_inputs(st, h, ca, cb, batch, gen, dev)
            x, m, weight, bias, stride, padding = args[:6]
            kernel = lambda: fused_pconv_train(  # noqa: E731
                x, m, weight, bias, stride, padding, x_skip=xs, packed=packed)
            plain = lambda: fused_pconv_train_plain(  # noqa: E731
                x, m, weight, bias, stride, padding, x_skip=xs)
            with torch.no_grad():
                got, got_m = kernel()
                want, want_m = plain()
                err = nrmse(got, want)
                t_k = time_ms(kernel, 5)
                try:
                    torch.backends.cudnn.benchmark = False
                    t_p = time_ms(plain, 5)
                    torch.backends.cudnn.benchmark = True
                    t_s = time_ms(plain, 5)
                finally:
                    torch.backends.cudnn.benchmark = flags
            plan = plan_stage(got[..., 0].numel(), got.shape[-1], ca, cb,
                              weight.shape[-1], sm_count(dev))
            rows.append(dict(ms=t_k, plain_ms=t_p, searched_ms=t_s))
            worst = max(worst, err)
            line("k2_train", batch=batch, stage=name, x=f"{batch}x{h}x{h}x{ca}+{cb}",
                 variant=plan.variant, splits=plan.splits, nrmse=f"{err:.3e}",
                 masks_equal=torch.equal(got_m, want_m), ms=f"{t_k:.4f}",
                 plain_ms=f"{t_p:.4f}", searched_ms=f"{t_s:.4f}")
            require(torch.isfinite(got).all().item(), f"K2 train {name}: non-finite output")
            require(err <= K2_TRAIN_NRMSE_TOL, f"K2 train {name} at batch {batch}: NRMSE {err}")
            require(torch.equal(got_m, want_m), f"K2 train {name}: new_mask differs")
            del args, xs, packed, got, want, got_m, want_m
        totals[batch] = {k: sum(r[k] for r in rows) for k in rows[0]}
        line("k2_train", batch=batch, stages=len(rows),
             **{k: f"{v:.4f}" for k, v in totals[batch].items()})
    return {"nrmse_max": worst, **{f"batch{b}": t for b, t in totals.items()},
            "timing": "forward alone, median of 5 CUDA-event calls; plain_ms with cuDNN's "
                      "search off (as the port trains), searched_ms with it on"}


def ffc_inputs(b: int, gen, dev, cl: int = FFC_LOCAL, cg: int = FFC_GLOBAL, h: int = FFC_SIDE,
               w: int = FFC_SIDE):
    """Seeded (x_l, x_g, s, w_l2l, w_g2l, w_l2g), a block FFC's by default:
    the inputs after a ReLU, He-normal weights."""
    t = [torch.relu(torch.randn((b, cl, h, w), generator=gen)),
         torch.relu(torch.randn((b, cg, h, w), generator=gen)),
         torch.randn((b, cg, h, w), generator=gen)]
    for cout, cin in ((cl, cl), (cl, cg), (cg, cl)):
        t.append(torch.randn((cout, cin, 3, 3), generator=gen) * math.sqrt(2.0 / (9 * cin)))
    return [v.to(dev) for v in t]


def ffc_flops(batch: int) -> float:
    """The three convolutions' operations at a block FFC's shapes."""
    cl, cg = FFC_LOCAL, FFC_GLOBAL
    return 2.0 * batch * FFC_SIDE**2 * 9 * (cl * (cl + cg) + cg * cl)


def ffc_bwd_inputs(b: int, gen, dev):
    """A block FFC's seeded inputs and weights (``ffc_inputs``) and the
    gradients of y_l and y_g."""
    args = ffc_inputs(b, gen, dev)
    return args, [torch.randn((b, c, FFC_SIDE, FFC_SIDE), generator=gen).to(dev)
                  for c in (FFC_LOCAL, FFC_GLOBAL)]


def ffc_library_child(search: bool) -> dict:
    """{"forward": {batch: ms}, "backward": {batch: ms}} of the plain
    version (``ffc_local_plain``) and the plain backward
    (``ffc_local_backward_plain``: three convolution_backward calls and the
    pads' backward) at FFC_BATCHES, cuDNN's search on or off, fp32, TF32
    off; run in a fresh process (``ffc_library_ms``)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = search
    gen = torch.Generator().manual_seed(SEED + 60)
    dev = torch.device("cuda", 0)
    out = {"forward": {}, "backward": {}}
    with torch.no_grad():
        for batch in FFC_BATCHES:
            args, grads = ffc_bwd_inputs(batch, gen, dev)
            out["forward"][batch] = time_ms(lambda: ffc_local_plain(*args), 20)
            out["backward"][batch] = time_ms(
                lambda: ffc_local_backward_plain(args[0], args[1], *args[3:], *grads), 20)
            del args, grads
    return out


def ffc_library_ms(search: bool) -> dict:
    """``ffc_library_child`` in a process of its own: torch keeps the first
    cuDNN algorithm it finds for a shape, searched or not, so in this one
    an earlier phase's choice would stand."""
    code = ("import json, chip_smoke as cs; "
            f"print(json.dumps(cs.ffc_library_child({search})))")
    res = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=600)
    require(res.returncode == 0,
            f"ffc: the cuDNN timing (search {search}) exited {res.returncode}: "
            f"{res.stderr[-2000:]}")
    got = json.loads(res.stdout.strip().splitlines()[-1])
    return {k: {int(b): ms for b, ms in v.items()} for k, v in got.items()}


def phase_ffc(dev):
    """``ffc_local`` (csrc/ffc_conv.cu) against its plain version at a block
    FFC's shapes at each of FFC_BATCHES: y_l's and y_g's NRMSE and worst
    error against the plain version in float64 (the plain version in fp32
    with cuDNN's heuristic, and in TF32, beside it; TF32 must fail the
    gate), bitwise equal over two calls; FFCLocal's gradients against
    autograd through the plain version; the times of the kernel (its pack
    included), the pack alone, and the plain version with cuDNN's search
    off (as the port trained) and, timed in a fresh process, on, beside
    the bound; then other shapes."""
    searched = ffc_library_ms(True)["forward"]
    gen = torch.Generator().manual_seed(SEED + 60)
    flags = torch.backends.cudnn.benchmark
    figures = {}
    for batch in FFC_BATCHES:
        args = ffc_inputs(batch, gen, dev)
        with torch.no_grad():
            got = ffc_local(*args)
            again = ffc_local(*args)
            want = ffc_local_plain(*(a.double() for a in args))
            # cuDNN's heuristic, its search off, as the port trained (searched: above)
            try:
                torch.backends.cudnn.benchmark = False
                plain = ffc_local_plain(*args)
                t_p = time_ms(lambda: ffc_local_plain(*args), 20)
                torch.backends.cudnn.allow_tf32 = True
                tf32 = ffc_local_plain(*args)
            finally:
                torch.backends.cudnn.benchmark = flags
                torch.backends.cudnn.allow_tf32 = False
        errs = {}
        for name, g, f, p, w in zip(("y_l", "y_g"), got, tf32, plain, want):
            errs[name] = dict(nrmse=nrmse(g, w), worst=((g.double() - w).abs().max()
                                                        / w.abs().max()).item(),
                              plain_nrmse=nrmse(p, w), tf32_nrmse=nrmse(f, w))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again, want, plain, tf32
        with torch.no_grad():
            t_k = time_ms(lambda: ffc_local(*args), 20)
            t_pack = time_ms(lambda: pack_pconv_weights(args[3:]), 20)
        # gradients: FFCLocal against autograd through the plain version in
        # float64, and cuDNN's fp32 (autograd through the plain version) beside it
        leaves = [a.detach().requires_grad_() for a in args]
        outs = ffc_local(*leaves)
        grads_out = [torch.randn(o.shape, generator=gen).to(dev) for o in outs]
        got_g = torch.autograd.grad(outs, leaves, grads_out)
        del outs
        leaves_p = [a.detach().requires_grad_() for a in args]
        plain_g = torch.autograd.grad(ffc_local_plain(*leaves_p), leaves_p, grads_out)
        leaves_64 = [a.detach().double().requires_grad_() for a in args]
        want_g = torch.autograd.grad(ffc_local_plain(*leaves_64), leaves_64,
                                     [g.double() for g in grads_out])
        grad_err = max(rel_l2(g, w) for g, w in zip(got_g, want_g))
        plain_grad_err = max(rel_l2(g, w) for g, w in zip(plain_g, want_g))
        del leaves, leaves_p, leaves_64, got_g, plain_g, want_g, grads_out
        # the inputs and weights read once, y_l (x_l's size) and y_g (s's) written once
        b = bound(ffc_flops(batch), nbytes(*args, args[0], args[2]), TF32X3_FLOPS)
        figures[f"batch{batch}"] = dict(ms=t_k, pack_ms=t_pack,
                                        plain_ms=t_p, searched_ms=searched[batch], **b,
                                        tflops=ffc_flops(batch) / t_k / 1e9, grad_rel_l2=grad_err,
                                        plain_grad_rel_l2=plain_grad_err,
                                        **{f"{k}_{m}": v for k, e in errs.items()
                                           for m, v in e.items()})
        line("ffc", batch=batch, shape=f"{batch}x({FFC_LOCAL}+{FFC_GLOBAL})x{FFC_SIDE}x{FFC_SIDE}",
             ms=f"{t_k:.4f}", pack_ms=f"{t_pack:.4f}",
             plain_ms=f"{t_p:.4f}", searched_ms=f"{searched[batch]:.4f}",
             bound_ms=f"{b['bound_ms']:.4f}",
             of_bound=f"{100 * b['bound_ms'] / t_k:.1f}%", bitwise=bitwise,
             grad_rel_l2=f"{grad_err:.3e}", plain_grad_rel_l2=f"{plain_grad_err:.3e}",
             **{f"{k}_{m}": f"{v:.3e}" for k, e in errs.items() for m, v in e.items()})
        for name, e in errs.items():
            require(e["nrmse"] <= FFC_NRMSE_TOL,
                    f"ffc {name} at batch {batch}: NRMSE {e['nrmse']} against float64")
            require(e["tf32_nrmse"] > FFC_NRMSE_TOL,
                    f"ffc {name}: TF32 reads {e['tf32_nrmse']}, within the gate")
        require(bitwise, f"ffc at batch {batch}: two calls differ")
        require(grad_err <= FFC_GRAD_TOL, f"ffc at batch {batch}: gradients {grad_err}")
        del args
    # other shapes the kernel takes: ragged channel groups, odd rows, a
    # width that is no multiple of 4 (its 4-byte copies) or of the 64-column tile
    for b, cl, cg, h, w in FFC_OTHER_SHAPES:
        args = ffc_inputs(b, gen, dev, cl, cg, h, w)
        with torch.no_grad():
            got = ffc_local(*args)
            want = ffc_local_plain(*(a.double() for a in args))
        err = max(nrmse(g, v) for g, v in zip(got, want))
        line("ffc", shape=f"{b}x({cl}+{cg})x{h}x{w}", nrmse=f"{err:.3e}")
        require(err <= FFC_NRMSE_TOL, f"ffc at {b}x({cl}+{cg})x{h}x{w}: NRMSE {err}")
    return figures


def phase_ffc_backward(dev):
    """``ffc_local_dgrad`` and ``ffc_local_wgrad`` (csrc/ffc_conv.cu), the
    backward of ``ffc_local``, at a block FFC's shapes at each of
    FFC_BATCHES: each output's NRMSE against its plain version in float64
    (the plain version in TF32 beside it, which must fail the gate),
    bitwise equal over two calls; the device ms a call of each (the dgrad
    with its pack and border kernel, the wgrad with its reduction) and of
    both, beside the plain backward's (``ffc_local_backward_plain``, as the
    port trained before: cuDNN's heuristic, its search off) and cuDNN's
    searched backward as the yardstick (``library_ms``), each timed in a
    fresh process, and the bound (each kernel the forward's operations at
    the 3xTF32 rate)."""
    plain = ffc_library_ms(False)["backward"]
    searched = ffc_library_ms(True)["backward"]
    gen = torch.Generator().manual_seed(SEED + 63)
    figures = {"ffc_local_dgrad": {}, "ffc_local_wgrad": {}}
    for batch in FFC_BATCHES:
        args, grads = ffc_bwd_inputs(batch, gen, dev)
        x_l, x_g, ws = args[0], args[1], args[3:]
        dgrad = lambda: ffc_local_dgrad(*grads, *ws)  # noqa: E731
        wgrad = lambda: ffc_local_wgrad(x_l, x_g, *grads)  # noqa: E731
        errs, bitwise = {}, {}
        with torch.no_grad():
            for name, run, plain_fn, plain_args, outs in (
                    ("dgrad", dgrad, ffc_local_dgrad_plain, grads + ws, ("x_l", "x_g")),
                    ("wgrad", wgrad, ffc_local_wgrad_plain, [x_l, x_g] + grads,
                     ("w_l2l", "w_g2l", "w_l2g"))):
                got, again = run(), run()
                bitwise[name] = all(torch.equal(a, b) for a, b in zip(got, again))
                want = plain_fn(*(a.double() for a in plain_args))
                try:
                    torch.backends.cudnn.allow_tf32 = True
                    torch.backends.cuda.matmul.allow_tf32 = True
                    tf32 = plain_fn(*plain_args)
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                    torch.backends.cuda.matmul.allow_tf32 = False
                errs[name] = {o: dict(nrmse=nrmse(g, w), tf32_nrmse=nrmse(f, w))
                              for o, g, w, f in zip(outs, got, want, tf32)}
                del got, again, want, tf32
            t_d, t_w = time_ms(dgrad, 20), time_ms(wgrad, 20)
            t_both = time_ms(lambda: (dgrad(), wgrad()), 20)
        b_d = bound(ffc_flops(batch), nbytes(*grads, *ws, x_l, x_g), TF32X3_FLOPS)
        b_w = bound(ffc_flops(batch), nbytes(x_l, x_g, *grads, *ws), TF32X3_FLOPS)
        for name, t, b in (("dgrad", t_d, b_d), ("wgrad", t_w, b_w)):
            figures[f"ffc_local_{name}"][f"batch{batch}"] = dict(
                ms=t, backward_ms=t_both, plain_ms=plain[batch], library_ms=searched[batch], **b,
                tflops=ffc_flops(batch) / t / 1e9, bitwise=bitwise[name],
                **{f"{o}_{m}": v for o, e in errs[name].items() for m, v in e.items()})
            line("ffc_bwd", kernel=name, batch=batch, ms=f"{t:.4f}",
                 backward_ms=f"{t_both:.4f}", plain_backward_ms=f"{plain[batch]:.4f}",
                 library_backward_ms=f"{searched[batch]:.4f}", bound_ms=f"{b['bound_ms']:.4f}",
                 of_bound=f"{100 * b['bound_ms'] / t:.1f}%", bitwise=bitwise[name],
                 **{f"{o}_{m}": f"{v:.3e}" for o, e in errs[name].items() for m, v in e.items()})
            for o, e in errs[name].items():
                require(e["nrmse"] <= FFC_BWD_NRMSE_TOL,
                        f"ffc_bwd {name} {o} at batch {batch}: NRMSE {e['nrmse']} against float64")
                require(e["tf32_nrmse"] > FFC_BWD_NRMSE_TOL,
                        f"ffc_bwd {name} {o}: TF32 reads {e['tf32_nrmse']}, within the gate")
            require(bitwise[name], f"ffc_bwd {name} at batch {batch}: two calls differ")
        del args, grads
    return figures


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def upsample_shapes(width: int):
    """(H, C) of the 7 decoder upsamples' inputs at SIZE^2."""
    w = width
    return [(SIZE >> 7, 8 * w), (SIZE >> 6, 8 * w), (SIZE >> 5, 8 * w),
            (SIZE >> 4, 8 * w), (SIZE >> 3, 4 * w), (SIZE >> 2, 2 * w),
            (SIZE >> 1, w)]


def k1_library(direction: str):
    """The one PyTorch call that computes K1 ``direction``, as a function
    of the NHWC source: torch's upsample on its NCHW view, or its backward."""
    if direction == "fwd":
        return lambda src: F.interpolate(src.permute(0, 3, 1, 2), scale_factor=2,
                                         mode="bilinear", align_corners=False)

    def backward(src):
        n, h2, w2, c = src.shape
        return torch.ops.aten.upsample_bilinear2d_backward(
            src.permute(0, 3, 1, 2), [h2, w2], [n, c, h2 // 2, w2 // 2], False, 2.0, 2.0)
    return backward


def graph_calls(est_ms: float) -> int:
    """Calls to capture in one graph so that a replay lasts about
    GRAPH_MIN_MS at ``est_ms`` a call, at most GRAPH_LAUNCHES."""
    return max(1, min(GRAPH_LAUNCHES, math.ceil(GRAPH_MIN_MS / max(est_ms, 1e-9))))


def past_l2(src, out_bytes: int, calls: int) -> list:
    """src (a tensor or a tuple of them) and copies of it, as many as make
    the inputs and outputs of ``calls`` calls pass twice the L2 (one where
    a call alone does)."""
    group = src if isinstance(src, tuple) else (src,)
    copies = min(calls, math.ceil(2 * L2_BYTES / (nbytes(*group) + out_bytes)))
    clone = (lambda: tuple(t.clone() for t in group)) if isinstance(src, tuple) else src.clone
    return [src] + [clone() for _ in range(copies - 1)]


def rotating(fn, srcs: list):
    """A call of fn on each of srcs in turn, each output held until its
    turn comes round again: captured in a graph, its calls read and write
    len(srcs) + 1 buffers each way, not the same one from L2."""
    held, turn = [None] * len(srcs), itertools.count()

    def call():
        k = next(turn) % len(srcs)
        held[k] = fn(srcs[k])
    return call


def k1_times(direction: str, src: torch.Tensor, kernel=None, yardsticks: bool = True) -> dict:
    """K1 ``direction`` at src's shape on the device by graph replay: the
    kernel (held to one kernel node a call), its plain version and its
    library call, with calls a graph scaled to the shape's byte bound and
    rotated over copies of src past the L2 (past_l2); the bound (each
    input read once, each output written once); the wrapper's host ms a
    call and the per-call CUDA-event ms (``call_ms``, the figure before
    graph replay: it holds the host's launch). ``kernel`` replaces the
    port's wrapper (a parent commit's, in profile_slice.py); without
    ``yardsticks`` the plain version and library call are not timed."""
    port, plain = ((upsample2x_fwd, upsample2x_fwd_plain) if direction == "fwd"
                   else (upsample2x_bwd, upsample2x_bwd_plain))
    kernel = kernel or port
    out = kernel(src)
    # per output value two FMAs and a multiply a tap pair (fwd); per dx
    # value 20 FMAs, 4 rows of 4 taps and then the rows (bwd)
    fig = bound((9.0 if direction == "fwd" else 40.0) * out.numel(), nbytes(src, out))
    calls = graph_calls(fig["bound_ms"])
    srcs = past_l2(src, nbytes(out), calls)
    what = f"K1 {direction} {'x'.join(map(str, src.shape))}"
    times = dict(ms=timed_on_device(what, rotating(kernel, srcs), kernels=1, launches=calls),
                 plain_ms=None, library_ms=None)
    if yardsticks:
        times.update(
            plain_ms=timed_on_device(f"{what} plain", rotating(plain, srcs), launches=calls),
            library_ms=timed_on_device(f"{what} library", rotating(k1_library(direction), srcs),
                                       launches=calls))
    return dict(**times, host_ms=host_ms(lambda: kernel(src)), call_ms=time_ms(lambda: kernel(src)),
                calls=calls, copies=len(srcs), **fig)


def k1_line(phase: str, batch: int, shape: str, r: dict, empty: float, **extra) -> None:
    text = lambda v: "-" if v is None else f"{v:.5f}"  # noqa: E731  (- : not timed in this turn)
    line(phase, batch=batch, shape=shape, ms=f"{r['ms']:.5f}", plain_ms=text(r["plain_ms"]),
         library_ms=text(r["library_ms"]), empty_ms=f"{empty:.5f}",
         bound_ms=f"{r['bound_ms']:.5f}", vs_bound=f"{r['ms'] / r['bound_ms']:.3f}",
         host_ms=f"{r['host_ms']:.4f}", call_ms=f"{r['call_ms']:.4f}", calls=r["calls"],
         copies=r["copies"], **extra)


def k1_figures(direction: str, rows, empty: float, worst: float) -> dict:
    """The kernels line's K1 entry: device ms by graph replay summed over
    the 7 shapes at batch 2 (ms, plain_ms, library_ms and the bound), the
    same at batch 8, and the largest shape at each."""
    def summed(batch):
        rs = [r for r in rows if r["batch"] == batch]
        return {k: sum(r[k] for r in rs) for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                    "host_ms", "call_ms")}
    out = dict(max_abs_err=worst, **summed(STAGE_BATCH), bound_by="bytes", empty_ms=empty,
               timing="device ms by CUDA graph replay, the 7 decoder shapes summed at batch 2")
    for batch in K1_BATCHES:
        largest = [r for r in rows if r["batch"] == batch][-1]
        out[f"batch{batch}"] = summed(batch)
        out[f"batch{batch}_largest"] = {k: largest[k] for k in
                                        ("shape", "ms", "plain_ms", "library_ms", "bound_ms")}
    return out


def k1_totals(phase: str, rows, batch: int) -> None:
    rs = [r for r in rows if r["batch"] == batch]
    t = {k: sum(r[k] for r in rs) for k in ("ms", "plain_ms", "library_ms", "bound_ms", "host_ms",
                                           "call_ms")}
    line(phase, batch=batch, shapes=len(rs), **{k: f"{v:.5f}" for k, v in t.items()},
         vs_bound=f"{t['ms'] / t['bound_ms']:.3f}")


def phase_k1(model, dev):
    """K1 fwd at the 7 decoder shapes, batch 2 and 8: fp32 equal to torch's
    bits, bf16 within 1 ulp (batch 2), and the times of k1_times."""
    gen = torch.Generator().manual_seed(SEED + 2)
    empty = timed_on_device("the empty launch", lambda: empty_launch(dev), kernels=1)
    rows, worst = [], 0.0
    for batch in K1_BATCHES:
        for h, c in upsample_shapes(model.base_width):
            x = torch.rand((batch, h, h, c), generator=gen).to(dev)
            err = (upsample2x_fwd(x) - upsample2x_fwd_plain(x)).abs().max().item()
            extra = {}
            if batch == STAGE_BATCH:
                xb = x.bfloat16()
                got_b = upsample2x_fwd(xb).float()
                want_b = upsample2x_fwd_plain(xb.float())
                ulps = ((got_b - want_b).abs() / _bf16_ulp(want_b)).max().item()
                require(ulps <= 1.0, f"K1 {h}x{c}: bf16 off by {ulps} ulp")
                t_b = timed_on_device("K1 fwd bf16", rotating(
                    upsample2x_fwd, past_l2(xb, 4 * nbytes(xb), GRAPH_LAUNCHES)), kernels=1)
                extra = dict(bf16_max_ulps=f"{ulps:.3f}", bf16_ms=f"{t_b:.5f}")
            r = dict(batch=batch, shape=f"{batch}x{h}x{h}x{c}", **k1_times("fwd", x))
            k1_line("k1", batch, r["shape"], r, empty, f32_max_abs_err=f"{err:.3e}", **extra)
            require(err <= K1_F32_ABS_TOL, f"K1 {batch}x{h}x{c}: fp32 err {err}: not torch's bits")
            worst = max(worst, err)
            rows.append(r)
            del x
        k1_totals("k1", rows, batch)
    return k1_figures("fwd", rows, empty, worst)


def phase_k1_bwd(model, dev):
    """K1 bwd at the 7 decoder shapes, batch 2 and 8: fp32 within
    K1_BWD_REL_TOL of torch's backward, and at batch 2 bf16 within 1 ulp
    and the adjointness <U x, g> = <x, U^T g>; the times of k1_times."""
    gen = torch.Generator().manual_seed(SEED + 4)
    empty = timed_on_device("the empty launch", lambda: empty_launch(dev), kernels=1)
    rows, worst = [], 0.0
    for batch in K1_BATCHES:
        for h, c in upsample_shapes(model.base_width):
            g = torch.randn((batch, 2 * h, 2 * h, c), generator=gen).to(dev)
            got, want = upsample2x_bwd(g), upsample2x_bwd_plain(g)
            require(got.shape == (batch, h, h, c), f"K1 bwd {h}x{c}: shape {tuple(got.shape)}")
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            require(err <= K1_BWD_REL_TOL * scale, f"K1 bwd {h}x{c}: fp32 err {err} > 1e-6 * {scale}")
            extra = dict(rel=f"{err / max(scale, 1e-30):.3e}")
            if batch == STAGE_BATCH:
                # bf16 on positive data: a sum of positive taps has no
                # cancellation, so the fp32 result of the bf16 inputs is
                # within rounding of exact
                gb = torch.rand((batch, 2 * h, 2 * h, c), generator=gen).to(dev).bfloat16()
                got_b = upsample2x_bwd(gb).float()
                want_b = upsample2x_bwd_plain(gb.float())
                ulps = ((got_b - want_b).abs() / _bf16_ulp(want_b)).max().item()
                x = torch.randn((batch, h, h, c), generator=gen).to(dev)
                prod = upsample2x_fwd(x).double() * g.double()
                adj = abs(prod.sum().item() - (x.double() * got.double()).sum().item())
                adj /= prod.abs().sum().item()
                require(ulps <= 1.0, f"K1 bwd {h}x{c}: bf16 off by {ulps} ulp")
                require(adj <= ADJOINT_TOL, f"K1 bwd {h}x{c}: not the adjoint of K1 fwd ({adj})")
                t_b = timed_on_device("K1 bwd bf16", rotating(
                    upsample2x_bwd, past_l2(gb, nbytes(gb) // 4, GRAPH_LAUNCHES)), kernels=1)
                extra.update(bf16_max_ulps=f"{ulps:.3f}", adjoint_rel=f"{adj:.3e}",
                             bf16_ms=f"{t_b:.5f}")
                del gb, x, prod
            r = dict(batch=batch, shape=f"{batch}x{2 * h}x{2 * h}x{c}", **k1_times("bwd", g))
            k1_line("k1_bwd", batch, r["shape"], r, empty, f32_max_abs_err=f"{err:.3e}", **extra)
            worst = max(worst, err)
            rows.append(r)
            del g, got, want
        k1_totals("k1_bwd", rows, batch)
    return k1_figures("bwd", rows, empty, worst)


def phase_pack(model):
    """pack_pconv_weights, the one launch a forward that packs K2's TF32
    planes of all 14 stages, against the plain packing: bitwise equal."""
    weights = [getattr(model, n).input_conv.weight.detach() for n in STAGES]
    got = pack_pconv_weights(weights)
    want = [pack_pconv_weight(w) for w in weights]
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for g, w in zip(got, want) for a, b in zip(g, w))
    equal = all(torch.equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))
    t_k = time_ms(lambda: pack_pconv_weights(weights))
    t_p = time_ms(lambda: [pack_pconv_weight(w) for w in weights])
    t_dev = device_ms(lambda: pack_pconv_weights(weights))
    t_host = host_ms(lambda: pack_pconv_weights(weights))
    n = sum(w.numel() for w in weights)
    # per element a subtraction beside two roundings; it moves its bytes
    fig = dict(max_abs_err=err, ms=t_k, plain_ms=t_p, library_ms=None,
               device_ms="unresolved" if t_dev is None else t_dev, host_ms=t_host,
               **bound(float(n), 12 * n))
    line("pack", stages=len(weights), weights=n, bitwise=equal, ms=f"{t_k:.4f}",
         device_ms=ms_text(t_dev, 4), host_ms=f"{t_host:.4f}", plain_ms=f"{t_p:.4f}",
         bound_ms=f"{fig['bound_ms']:.4f}", bound_by=fig["bound_by"])
    require(equal, f"pack: the kernel's planes differ from the plain packing ({err})")
    return fig


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

    reset_counts(counters)
    t0 = time.perf_counter()
    with dec2_features(model) as got_feat:
        out_f = np.concatenate([o for _, o in inp_f.stream_from(iter(chunks))])
    t1 = time.perf_counter()
    out_u8 = np.concatenate([o for _, o in inp_u8.stream_from(iter(chunks))])
    t2 = time.perf_counter()
    launches = read_counts(counters)
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
         k3_launches=launches["fused_decoder_tail"], pack_launches=launches["pack_pconv_weights"],
         k2_variants={v: launches[f"fused_pconv_eval.{v}"] for v in fused_pconv_eval.variants},
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
            "fused_decoder_tail": 1, "pack_pconv_weights": 1}
    require(all(launches[k] == v * forwards for k, v in want.items()),
            f"slice: launches {launches} in {forwards} forwards, want {want} each")
    require_k2_variants("slice", launches, forwards)
    return launches


def require_k2_variants(phase: str, launches: dict, forwards: int) -> None:
    """Every stage is one launch of one variant, a split stage's sum the
    second: enc1 on the one-channel variant, none on SIMT, the rest MMA."""
    v = {k.split(".")[1]: n for k, n in launches.items() if k.startswith("fused_pconv_eval.")}
    require(v["mma_c1"] == forwards and v["simt"] == 0
            and v["mma_c1"] + v["mma"] + v["mma_split"] == 13 * forwards
            and v["split_reduce"] == v["mma_split"] > 0,
            f"{phase}: K2 variants {v} in {forwards} forwards: want 1 enc1 (mma_c1), 0 SIMT, "
            "the rest MMA, some split")


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
        reset_counts(counters)
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
        require(one_launches == (13, 6, 0, 1, 1, 0), f"files: evaluate launched {one_launches}")
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
        reset_counts(counters)
        t0 = time.perf_counter()
        result = train(root / "train" / "images", root / "train" / "masks", state, cfg,
                       checkpoint_path=best, val_img_dir=root / "val" / "images",
                       val_mask_dir=root / "val" / "masks", vgg=vgg, image_size=SIZE, seed=SEED)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts(counters)
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
         k2_train_launches=launches["fused_pconv_train"],
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
            and launches["fused_decoder_tail"] == val_fwd
            and launches["fused_pconv_train"] == 14 * steps
            and launches["pack_pconv_weights"] == val_fwd + steps,
            f"train: K2, K3, K2's train variant and the pack launched "
            f"{launches['fused_pconv_eval']}, {launches['fused_decoder_tail']}, "
            f"{launches['fused_pconv_train']} and {launches['pack_pconv_weights']} times: 13, 1, "
            "0 and 1 per validation forward, 0, 0, 14 and 1 per train step")
    require(saved_ok and n_adam[0] == 58 and n_adam[1] == 16,
            f"train: the checkpoint did not reload (Adam entries {n_adam})")
    require(state.generator.training, "train: G left in eval mode after validation")
    return launches


def phase_lama(dev):
    """Big-LaMa on the main paths, its block FFCs on ffc_local: one GAN step
    of ``make_train_step`` at batch 2 (seeded G, D and VGG, the full loss)
    and ``evaluate`` on one 512^2 PNG tile with G in eval mode, the
    counter set to 0 before each."""
    from PIL import Image

    gen = torch.Generator().manual_seed(SEED + 61)
    state = GANTrainState.create(init_generator(WIDTH, gen, dev, arch="big_lama"),
                                 init_discriminator(WIDTH, gen, dev))
    vgg = init_vgg(gen, dev)
    blocks = state.generator.sizes["n_blocks"]
    imgs, masks = dsm_tiles(2, SIZE, SEED + 62)
    ffc_local.launches = ffc_local_dgrad.launches = ffc_local_wgrad.launches = 0
    metrics = make_train_step(LoopConfig(batch_size=2).loss_config())(
        state, device_batch(imgs, masks, dev), vgg)
    train_launches = ffc_local.launches
    train_bwd = (ffc_local_dgrad.launches, ffc_local_wgrad.launches)
    state.generator.eval()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lama_") as tmp:
        root = Path(tmp)
        Image.fromarray(imgs[0, ..., 0]).save(root / "t000.png")
        Image.fromarray(masks[0, ..., 0]).save(root / "t000_mask_resized.png")
        ffc_local.launches = ffc_local_dgrad.launches = ffc_local_wgrad.launches = 0
        out = evaluate(root / "t000.png", root / "t000_mask_resized.png", state.generator,
                       root / "out.png")
        eval_launches = ffc_local.launches
        eval_bwd = (ffc_local_dgrad.launches, ffc_local_wgrad.launches)
        size = Image.open(out).size
    losses = [metrics[k].item() for k in ("g_loss", "d_loss")]
    line("lama", train_step="gan batch 2", g_loss=f"{losses[0]:.5f}", d_loss=f"{losses[1]:.5f}",
         train_step_launches=train_launches, evaluate_launches=eval_launches,
         train_step_dgrad_wgrad=train_bwd, evaluate_dgrad_wgrad=eval_bwd,
         block_ffcs=2 * blocks, written=size)
    require(all(math.isfinite(v) for v in losses), f"lama: non-finite losses {losses}")
    require(train_launches == eval_launches == 2 * blocks,
            f"lama: ffc_local launched {train_launches} times in a GAN step and {eval_launches} "
            f"in evaluate, not {2 * blocks} (one forward each)")
    require(train_bwd == (2 * blocks, 2 * blocks) and eval_bwd == (0, 0),
            f"lama: the FFC backward's dgrad and wgrad launched {train_bwd} times in a GAN "
            f"step and {eval_bwd} in evaluate, not {2 * blocks} each and none")
    require(size == (OUTPUT_SIZE, OUTPUT_SIZE), f"lama: evaluate wrote {size}")
    del state, vgg
    return {"ffc_local": train_launches + eval_launches, "ffc_local_dgrad": train_bwd[0],
            "ffc_local_wgrad": train_bwd[1]}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-300)).item()


def upsample_grads(G, objective, upsample=None, stage=fused_pconv_eval):
    """(gradient at dec1's upsample input, {block: weight gradient}) of one
    forward and backward of ``objective(forward)``, a loss of the train-mode
    generator ``G``'s forward. ``upsample``: None for the model's own path
    (K1 fwd and bwd, K2's train stages), else the upsample of a forward
    whose PConv stages are ``stage``'s train stages (K2's by default, the
    plain partial conv with ``fused_pconv_eval_plain``) and whose tail is
    plain (``forward`` is then that forward, else None)."""
    G.zero_grad(set_to_none=True)
    up_grad = []

    def capture(mod, args, out):
        # dec2's output feeds only the tail's upsample: its gradient is K1 bwd's output
        out[0].register_hook(up_grad.append)

    forward = None
    if upsample is not None:
        forward = lambda x, m: G._run(  # noqa: E731
            x, m, stage, upsample, fused_decoder_tail_plain)
    hook = G.dec2.register_forward_hook(capture)
    try:
        objective(forward).backward()
    finally:
        hook.remove()
    blocks = {n: p.grad.detach().clone() for n, p in G.named_parameters()
              if n.endswith("input_conv.weight") or n == "final.weight"}
    return up_grad[0].detach().clone(), blocks


def g_objective_grads(state, vgg, batch, snapshot, upsample=None, stage=fused_pconv_eval):
    """upsample_grads of the G objective (G and D) from the snapshot's weights."""
    state.generator.load_state_dict(snapshot[0])
    state.discriminator.load_state_dict(snapshot[1])
    return upsample_grads(state.generator, lambda forward: generator_objective(
        state, batch, vgg, LoopConfig().loss_config(), forward=forward)[0], upsample, stage)


def grads_against_plain(counters, run):
    """``run(upsample[, stage])`` (upsample_grads) through the kernels, through
    torch's own upsample (the same K2 train stages: K1's forward gives torch's
    bits, so the two differ in K1's backward alone) and through it with
    TF32, cuDNN deterministic: the launches of the kernel run and each run's
    rel L2 to the plain one, at dec1's upsample input and per block. Beside
    them, "cudnn": torch's upsample and the plain partial conv (cuDNN's
    forward in place of K2's: fp32 sums in another order), information."""
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        before = [fn.launches for fn in counters]
        got = {"kernel": run(None)}
        kernel_launches = [fn.launches - b for fn, b in zip(counters, before)]
        plain = run(upsample2x_fwd_plain)
        got["cudnn"] = run(upsample2x_fwd_plain, fused_pconv_eval_plain)
        torch.backends.cudnn.allow_tf32 = True
        try:
            got["tf32"] = run(upsample2x_fwd_plain)
        finally:
            torch.backends.cudnn.allow_tf32 = False
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    up = {k: rel_l2(v[0], plain[0]) for k, v in got.items()}
    blocks = {k: {n: rel_l2(v[1][n], plain[1][n]) for n in plain[1]} for k, v in got.items()}
    return kernel_launches, plain[0].shape, up, blocks


def phase_train_grad(dev, counters):
    imgs, masks = dsm_tiles(TRAIN_BATCH, SIZE, SEED + 8)
    batch = device_batch(imgs, masks, dev)
    state, vgg = train_state(SEED + 9, dev)
    snapshot = (copy.deepcopy(state.generator.state_dict()),
                copy.deepcopy(state.discriminator.state_dict()))
    kernel_launches, shape, up, blocks = grads_against_plain(
        counters, lambda upsample, stage=fused_pconv_eval: g_objective_grads(
            state, vgg, batch, snapshot, upsample, stage))
    worst = {k: max(b.values()) for k, b in blocks.items()}
    line("train_grad", batch=TRAIN_BATCH, up_grad="x".join(map(str, shape)),
         kernel_launches=kernel_launches,
         **{f"{k}_up_rel_l2": f"{v:.3e}" for k, v in up.items()},
         **{f"{k}_block_rel_l2_max": f"{v:.3e}" for k, v in worst.items()})
    for n in blocks["kernel"]:
        print(f"  {n}: " + " ".join(f"{k}={b[n]:.3e}" for k, b in blocks.items()), flush=True)
    # K2 eval, K1 fwd and bwd, K3, the pack, K2's train variant
    require(kernel_launches == [0, 7, 7, 0, 1, 14],
            f"train_grad: kernel path launched {kernel_launches}")
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


def k3_work(b: int, h: int, w: int, c: int, skip: bool) -> dict:
    """K3's operations at d [b,h,w,c]: dec1's fp32 products, counted once
    (not the halo the kernel computes again), and the fp32 FMAs of the final
    conv and, with k_skip, the skip term."""
    px = 4.0 * b * h * w
    return {"dec1": 2.0 * px * 9 * c * c, "fp32": 2.0 * px * 9 * c * (2 if skip else 1)}


def k3_bound(work: dict, moved: float) -> dict:
    """K3's bound: dec1 at the 3xTF32 rate plus the rest at fp32's, or its
    bytes over the memory's rate, whichever is larger."""
    t_ops = (work["dec1"] / TF32X3_FLOPS + work["fp32"] / FP32_FLOPS) * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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
                again = fused_decoder_tail(*a)
                want = fused_decoder_tail_plain(*a)
                torch.cuda.synchronize()
                key = f"{wname}_{'skip' if skip else 'one_input'}"
                hole = want[a[3] == 0].double()  # sigmoid(logit) where xm = 0
                errs[key] = (nrmse(got, want), (got - want).abs().max().item(),
                             torch.log(hole / (1 - hole)).std().item())
                require(got.shape == (STAGE_BATCH, SIZE, SIZE, 1) and torch.isfinite(got).all().item(),
                        f"k3 {key}: shape {tuple(got.shape)} or non-finite output")
                require(torch.equal(got, again), f"k3 {key}: two calls on the same inputs differ")
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
    work = k3_work(*d.shape, skip=False)
    # library_ms: the unfused kernel path the fused tail replaces; no one
    # PyTorch call computes the tail
    fig = dict(ms=t_k, plain_ms=t_p, library_ms=t_u,
               **k3_bound(work, nbytes(d, dm, xin, m, fused, *own)))
    flop = work["dec1"] + work["fp32"]
    for key, (e, mx, logit_std) in errs.items():
        line("k3", form=key, nrmse=f"{e:.3e}", max_abs_err=f"{mx:.3e}",
             hole_logit_std=f"{logit_std:.4f}" if logit_std else "-")
    line("k3", d="x".join(map(str, d.shape)), ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}",
         unfused_kernel_path_ms=f"{t_u:.4f}", bound_ms=f"{fig['bound_ms']:.4f}",
         bound_by=fig["bound_by"], gflop=f"{flop / 1e9:.2f}",
         tflops=f"{flop / t_k / 1e9:.2f}", vs_bound=f"{t_k / fig['bound_ms']:.2f}",
         nrmse_vs_unfused=f"{vs_unfused:.3e}")
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
        reset_counts(counters)
        t0 = time.perf_counter()
        workers = [threading.Thread(target=one, args=(i,)) for i in range(SERVE_REQUESTS)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        seconds = time.perf_counter() - t0
        outs[SERVE_REQUESTS:] = client.inpaint_batch(
            [(imgs[i], masks[i]) for i in range(SERVE_REQUESTS, n)])
        launches = read_counts(counters)
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
            "upsample2x_bwd": 0, "pack_pconv_weights": 1}
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


def device_ms(fn, calls: int = 20):
    """Device time a call of fn takes on the card, from torch.profiler's device
    events, or None where it recorded fewer events than fn's launches (every
    call timed here launches at least one kernel; the profiler can drop a
    launch-sized kernel's events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if len(events) < calls:
        return None
    return sum(e.time_range.elapsed_us() for e in events) / calls / 1e3


def ms_text(ms, digits: int = 5) -> str:
    """A device time as printed: 'unresolved' where it was not measured."""
    return "unresolved" if ms is None else f"{ms:.{digits}f}"


def graph_kernel_nodes(graph) -> int:
    """The kernel nodes of a captured, kept CUDA graph (libcuda's
    cuGraphGetNodes and cuGraphNodeGetType): the launches it recorded."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    require(cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    require(cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        require(cuda.cuGraphNodeGetType(node, ctypes.byref(kind)) == 0, "cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def graph_device_ms(fn, launches: int = GRAPH_LAUNCHES, replays: int = GRAPH_REPLAYS):
    """(device ms a call, kernel launches a call) of fn, every launch recorded:
    fn warmed up on a side stream, ``launches`` calls captured in one CUDA
    graph (the wrappers launch on the current stream, the capture stream),
    the graph replayed once to warm it, then the median of ``replays``
    replays timed with CUDA events, over ``launches``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(launches):
            fn()
    kernels = graph_kernel_nodes(graph) / launches
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    graph.reset()
    return statistics.median(times) / launches, kernels


def probe_check(name: str, got, want, label: str = "") -> float:
    """Probe ``name``'s result against its plain version: P4 and P5 equal,
    P1-P3 within PROBE_SUM_REL_TOL of max|plain|; the max abs error."""
    torch.cuda.synchronize()
    what = f"probes {name}{label}"
    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    if name in ("probe_mask_broadcast", "probe_row_build"):
        require(torch.equal(got, want), f"{what}: not equal to its plain version ({err})")
    else:
        scale = want.abs().max().item()
        require(err <= PROBE_SUM_REL_TOL * scale,
                f"{what}: err {err} > {PROBE_SUM_REL_TOL} * {scale}")
    return err


def timed_on_device(what: str, fn, kernels=None, launches: int = GRAPH_LAUNCHES) -> float:
    """graph_device_ms of fn over ``launches`` calls; where ``kernels`` is
    given, the graph must hold exactly that many kernel launches a call."""
    ms, per_call = graph_device_ms(fn, launches)
    require(kernels is None or per_call == kernels,
            f"the graph of {what} holds {per_call} kernels a call, not {kernels}")
    return ms


def phase_probes(dev):
    """P1-P5 against their plain versions at probe_mosaic's shapes and seed
    (P1-P4 in each variant), then against numpy as probe_cuda prints
    it; device times per launch by graph replay beside an empty launch's
    and the library call's (P3's: the product alone, torch.matmul on the
    pre-built [a, 2a], since no one call takes a and k2)."""
    libraries = {"probe_lane_reduce": torch.matmul, "probe_matvec_dot": torch.matmul,
                 "probe_mask_broadcast": lambda a, m: a * m[..., None]}
    empty = timed_on_device("the empty launch", lambda: empty_launch(dev), kernels=1)
    empty_call = time_ms(lambda: empty_launch(dev))
    empty_prof = device_ms(lambda: empty_launch(dev))
    figures = {}
    for _, fn, np_args, _, _ in probe_cases(*probe_inputs()):
        name = fn.__name__
        args = [torch.from_numpy(x).to(dev) for x in np_args]
        got, want = fn(*args), PLAIN[fn](*args)
        err = probe_check(name, got, want)
        library = libraries.get(name)
        t_k = timed_on_device(name, lambda: fn(*args), kernels=1)
        t_p = timed_on_device(f"{name}'s plain version", lambda: PLAIN[fn](*args))
        t_l = timed_on_device(f"{name}'s library call", lambda: library(*args)) if library else None
        t_prod = None
        if name == "probe_lane_concat_dot":
            cat = torch.cat([args[0], args[0] * 2.0], -1)
            t_prod = timed_on_device(f"{name}'s product alone",
                                     lambda: torch.matmul(cat, args[1]))
        t_call = time_ms(lambda: fn(*args))
        t_prof = device_ms(lambda: fn(*args))
        t_lprof = device_ms(lambda: library(*args)) if library else None
        fig = dict(max_abs_err=err, ms=t_k, plain_ms=t_p, **probe_work(name, args, got),
                   library_ms=t_l, empty_ms=empty, call_ms=t_call,
                   device_ms="unresolved" if t_prof is None else t_prof,
                   library_device_ms="unresolved" if t_lprof is None else t_lprof)
        if t_prod is not None:
            fig.update(product_alone_ms=t_prod,
                       product_alone="torch.matmul on the pre-built [a, 2a] (the concat outside)")
        variants = {}
        if hasattr(fn, "variants"):
            for v in VARIANTS:  # forced through the planner at the script's shapes
                ev = probe_check(name, fn(*args, variant=v), want, f" {v}")
                variants[v] = dict(max_abs_err=ev, ms=timed_on_device(
                    f"{name} {v}", lambda: fn(*args, variant=v), kernels=1))
            # as planned on a view at a 4-byte offset: the scalar variant
            buf = torch.empty(args[0].numel() + 1, device=dev)
            view = buf[1:].view(args[0].shape).copy_(args[0])
            require(plan_probe(name, view, *args[1:])[0] == "scalar",
                    f"probes {name}: a view at a 4-byte offset is not planned scalar")
            probe_check(name, fn(view, *args[1:]), PLAIN[fn](view, *args[1:]), " offset view")
            fig["variant_ms"] = {v: f["ms"] for v, f in variants.items()}
            fig["variant_max_abs_err"] = {v: f["max_abs_err"] for v, f in variants.items()}
        line("probes", probe=name, args="+".join("x".join(map(str, a.shape)) for a in args),
             out="x".join(map(str, got.shape)), max_abs_err=f"{err:.3e}",
             rel=f"{err / max(want.abs().max().item(), 1e-30):.3e}",
             device_ms=f"{t_k:.5f}", plain_device_ms=f"{t_p:.5f}",
             library_device_ms="none" if t_l is None else f"{t_l:.5f}",
             **({} if t_prod is None else {"product_alone_matmul_device_ms": f"{t_prod:.5f}"}),
             empty_device_ms=f"{empty:.5f}", call_ms=f"{t_call:.4f}",
             profiler_ms=ms_text(t_prof),
             library_profiler_ms="none" if library is None else ms_text(t_lprof),
             **{f"{v}_device_ms": f"{f['ms']:.5f}" for v, f in variants.items()},
             bound_ms=f"{fig['bound_ms']:.6f}", bound_by=fig["bound_by"])
        figures[name] = fig
    results = run_probes(dev)
    for r in results:
        print("  probe_cuda:", r.line(), flush=True)
    require(all(r.ok for r in results), "probes: a probe failed against numpy")
    line("probes", empty_device_ms=f"{empty:.5f}", empty_call_ms=f"{empty_call:.4f}",
         empty_profiler_ms=ms_text(empty_prof), graph_launches=GRAPH_LAUNCHES,
         graph_replays=GRAPH_REPLAYS)
    return figures


def phase_doctor(counters):
    """doctor.main([]) on the card: exit 0, no FAIL or WARN on the rows the
    card decides, and all five probes OK."""
    out = io.StringIO()
    reset_counts(counters)
    with contextlib.redirect_stdout(out):
        code = doctor.main([])
    launches = read_counts(counters)
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
        reset_counts(counters)
        t0 = time.perf_counter()
        try:
            code = main_pipeline.main(["--mode", "evaluate", "--config", "config.yaml"])
            seconds = time.perf_counter() - t0
            launches = read_counts(counters)
            mesh_code = main_pipeline.main(["--mode", "evaluate", "--mesh", "2", "--config",
                                            "config.yaml"])
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
    line("cli", exit=code, mesh_exit=mesh_code, grids=len(CLI_GRIDS), tiles=n_png,
         u8_max_diff_vs_unfused=diff, colored_is_lut=lut_ok, forwards=forwards,
         seconds=f"{seconds:.2f}", k2_launches=launches["fused_pconv_eval"],
         k1_launches=launches["upsample2x_fwd"], k3_launches=launches["fused_decoder_tail"],
         k2_variants={v: launches[f"fused_pconv_eval.{v}"] for v in fused_pconv_eval.variants})
    require(code == 0, f"cli: evaluate exited {code}")
    require(mesh_code == 2, f"cli: --mesh exited {mesh_code}, not 2")
    require(n_png == len(CLI_GRIDS) * CLI_TILES, f"cli: {n_png} tiles written")
    require(diff <= SLICE_U8_TOL, f"cli: {diff} grey levels from the unfused path")
    require(lut_ok, "cli: a colored PNG is not the LUT of its inpainted PNG")
    want = {"fused_pconv_eval": 13, "upsample2x_fwd": 6, "upsample2x_bwd": 0,
            "fused_decoder_tail": 1, "pack_pconv_weights": 1}
    require(all(launches[k] == v * forwards for k, v in want.items()),
            f"cli: launches {launches} in {forwards} forwards, want {want} each")
    require_k2_variants("cli", launches, forwards)
    return launches


# the train_mode phase: one synthetic Digimap parent zip, as
# scripts/bench_ingest.py builds it (seed 7, DSM 500^2 .asc, RGB JPEG at
# quality 95), of 4x4 child tiles at 2000^2, whose split gives 5 train, 5
# val and 6 test tiles: one train step of 5 and one validation forward of 5
TRAIN_MODE_GRID, TRAIN_MODE_SIDE, TRAIN_MODE_RGB, TRAIN_MODE_DSM = "NS00", 4, 2000, 500
NATIVE_RGB = 4000  # Digimap's 25 cm RGB tile
TRAIN_MODE_BATCH = 8
# card against CPU detectors on one tile: equal masks, or this combined-mask IoU
DETECTOR_IOU_TOL = 0.999
# the drill runs the same command at batch 3, so that the epoch's 5 train
# tiles make two batches (3 and 2): it preempts before the second, after one
# step, and preempted.pth holds a trained state
TRAIN_MODE_FAULT, TRAIN_MODE_DRILL_BATCH = "preempt@0:1", 3
TRAIN_MODE_CONFIG = """\
# the train_mode phase's config: one epoch, full-width 512^2
training:
  modes:
    initial:
      epochs: 1
      batch_size: {batch}
evaluation:
  checkpoint_dir: ckpts
mask_processing:
  visualization:
    enabled: false
experiment_tracking:
  enabled: false
data:
  raw_dir: data/raw
  processed_dir: data/processed
  output_dir: data/output
  input_zip_folder: data/zips
  models_dir: data/models
  image_size: 512
"""
DETECTED = (MaskType.ROADS, MaskType.VEGETATION, MaskType.FIELDS)


def aerial_tile(rng, px: int) -> np.ndarray:
    """scripts/bench_ingest.py's BGR tile (textured ground, green patches,
    diagonal roads) with a block of dark furrows (a ploughed field) and
    near-axis roads, so that every detector finds something."""
    yy, xx = np.mgrid[0:px, 0:px]
    img = rng.integers(60, 120, (px, px, 3), dtype=np.uint8)
    fy, fx = (int(v) for v in rng.integers(0, px // 2, 2))
    field = (yy >= fy) & (yy < fy + px // 3) & (xx >= fx) & (xx < fx + px // 3)
    img[field & (yy % 10 < 6)] = (35, 45, 50)
    img[(yy // 97 + xx // 83) % 5 == 0] = (40, 140, 50)  # green
    img[np.abs(yy - xx) % 211 < 3] = (180, 180, 178)  # road-ish, diagonal
    for _ in range(2):  # near-axis roads, about 8 and 84 degrees
        c = int(rng.integers(px // 8, px - px // 8))
        img[np.abs(yy - c - (xx * 0.14).astype(int)) < 5] = (185, 185, 182)
        img[np.abs(xx - c - (yy * 0.1).astype(int)) < 5] = (185, 185, 182)
    return img


def jpeg(bgr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def digimap_zip(root: Path, side: int, rgb_px: int, seed: int = 7) -> Path:
    """A synthetic Digimap parent zip of side^2 DSM (.asc) + RGB (JPEG) tiles."""
    import zipfile

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    path = root / f"{TRAIN_MODE_GRID}.zip"
    with tempfile.TemporaryDirectory() as tmp, zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for x in range(side):
            for y in range(side):
                name = f"{TRAIN_MODE_GRID[:2].lower()}{x:02d}{y:02d}"
                asc = Path(tmp) / f"{name}_DSM.asc"
                write_asc(asc, rng.uniform(0, 120, (TRAIN_MODE_DSM, TRAIN_MODE_DSM)))
                zf.write(asc, f"getmapping-dsm-2000_1234/{asc.name}")
                zf.writestr(f"getmapping_rgb_25cm_1234/{name}_rgb.jpg",
                            jpeg(aerial_tile(rng, rgb_px)))
    return path


class LogRecords(logging.Handler):
    """Keeps the records of the port's loggers (the CLI replaces the root's handlers)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def errors(self):
        return [r.getMessage() for r in self.records if r.levelno >= logging.ERROR]


def detector_ms(pipeline, bgr: np.ndarray):
    """Each detector's masks and ms on one BGR tile on the pipeline's device."""
    img = torch.from_numpy(np.ascontiguousarray(bgr)).to(pipeline.device)
    masks, ms = {}, {}
    for kind, det in pipeline.detectors.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks[kind] = det.detect(img)  # a host array: the detector has synced
        ms[kind.value] = (time.perf_counter() - t0) * 1e3
    return masks, ms


@contextlib.contextmanager
def watched_detectors():
    """{kind: [(ms, detected pixels) a call]} of the four detectors while
    open. The pipeline runs them one tile at a time, so a call's host clock
    is its own, beside the ingest's other threads decoding and writing."""
    classes = {MaskType.ROADS: RoadDetector, MaskType.BUILDINGS: BuildingDetector,
               MaskType.VEGETATION: VegetationDetector, MaskType.FIELDS: FieldDetector}
    calls = {kind: [] for kind in classes}
    own = {cls: cls.__dict__.get("detect") for cls in classes.values()}
    for kind, cls in classes.items():
        def detect(self, image, _detect=cls.detect, _calls=calls[kind]):
            t0 = time.perf_counter()
            mask = _detect(self, image)  # a host array: the detector has synced
            _calls.append(((time.perf_counter() - t0) * 1e3, int(np.count_nonzero(mask))))
            return mask
        cls.detect = detect
    try:
        yield calls
    finally:
        for cls, detect in own.items():
            if detect is None:
                del cls.detect
            else:
                cls.detect = detect


def ingest_seconds(records) -> float:
    """A CLI train run's ingest of its one grid, from its log: the grid's
    first line to the count of tiles processed (extraction, DSM PNGs,
    detectors, mask writes)."""
    start = next(r.created for r in records if r.msg == "=== processing parent grid %s ===")
    end = next(r.created for r in records if r.msg == "%s: %d tiles processed, %d failed")
    return end - start


def split_tiles(proc: Path, splits=("train", "val", "test")) -> dict:
    """The ingested tiles of the splits, in order, as the loader reads them."""
    items = []
    for split in splits:
        ds = InpaintingDataset(proc / split / "images", proc / split / "masks", size=SIZE)
        items += [ds[i] for i in range(len(ds))]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def batch_sizes(n: int, batch: int) -> set:
    """The sizes of the batches a loader gives of n items (the last partial)."""
    return {min(batch, n - i) for i in range(0, n, batch)}


def k1_errors(width: int, b: int, gen, dev):
    """K1 fwd's largest error and K1 bwd's largest error over max|plain|
    against their plain versions at the 7 upsample shapes, batch b."""
    fwd_err = bwd_rel = 0.0
    for h, c in upsample_shapes(width):
        u = torch.rand((b, h, h, c), generator=gen).to(dev)
        g = torch.randn((b, 2 * h, 2 * h, c), generator=gen).to(dev)
        fwd_err = max(fwd_err, (upsample2x_fwd(u) - upsample2x_fwd_plain(u)).abs().max().item())
        want_g = upsample2x_bwd_plain(g)
        bwd_rel = max(bwd_rel, (upsample2x_bwd(g) - want_g).abs().max().item()
                      / max(want_g.abs().max().item(), 1e-30))
    return fwd_err, bwd_rel


def hold_path_batches(model, tiles: dict, batches, dev) -> None:
    """The kernels at each batch the train mode gave them, against their plain
    versions: the validation forward (the master's weights on ingested
    tiles) on the composite and dec2's features, K2 at the 14 stages and K1
    fwd and bwd at the 7 upsample shapes, at the tolerances of their phases."""
    gen = torch.Generator().manual_seed(SEED + 34)
    model.eval()
    n = len(tiles["image"])
    for b in sorted(batches):
        idx = [i % n for i in range(b)]
        x = torch.from_numpy(tiles["image"][idx]).to(dev)
        m = torch.from_numpy(tiles["mask"][idx]).to(dev)
        with torch.inference_mode():
            xm = x * m
            with dec2_features(model) as got_feat:
                got = model(xm, m)
            with dec2_features(model) as want_feat:
                want = model.forward_plain(xm, m)
        err, feat_err = nrmse(got, want), nrmse(got_feat[0], want_feat[0])
        k2_rel, k2_masks = 0.0, True
        for name, h, ca, cb, st in stage_geometries(model, SIZE):
            args, xs, packed = stage_inputs(st, h, ca, cb, b, gen, dev)
            with torch.inference_mode():
                got_s, got_m = fused_pconv_eval(*args, x_skip=xs, packed=packed)
                want_s, want_m = fused_pconv_eval_plain(*args, x_skip=xs)
            rel = (got_s - want_s).abs().max().item() / max(want_s.abs().max().item(), 1e-30)
            require(rel <= K2_REL_TOL and torch.equal(got_m, want_m),
                    f"train_mode: K2 {name} at batch {b}: rel err {rel}, "
                    f"masks equal {torch.equal(got_m, want_m)}")
            k2_rel = max(k2_rel, rel)
        fwd_err, bwd_rel = k1_errors(model.base_width, b, gen, dev)
        line("train_mode_batch", batch=b, nrmse=f"{err:.3e}", dec2_nrmse=f"{feat_err:.3e}",
             k2_rel_max=f"{k2_rel:.3e}", k1_fwd_max_abs_err=f"{fwd_err:.3e}",
             k1_bwd_rel_max=f"{bwd_rel:.3e}")
        require(got.shape == (b, SIZE, SIZE, 1) and torch.isfinite(got).all().item(),
                f"train_mode: the forward at batch {b}: shape {tuple(got.shape)} or non-finite")
        require(err <= SLICE_NRMSE_TOL, f"train_mode: forward at batch {b}: NRMSE {err}")
        require(feat_err <= FEAT_NRMSE_TOL, f"train_mode: dec2 at batch {b}: NRMSE {feat_err}")
        require(fwd_err <= K1_F32_ABS_TOL, f"train_mode: K1 fwd at batch {b}: err {fwd_err}")
        require(bwd_rel <= K1_BWD_REL_TOL, f"train_mode: K1 bwd at batch {b}: rel err {bwd_rel}")


def g_params(state) -> dict:
    return {k: v.detach().cpu() for k, v in state.generator.named_parameters()}


def phase_train_mode(dev, counters, card: str):
    """The CLI's --mode train on the card: a Digimap zip through the ingest and
    its detectors, the checkerboard split, one epoch from a seeded master, the
    master checkpoint; the kernels at the run's batches against their plain
    versions; the preemption drill; the detectors on the card against the
    CPU; the ingest's, the detectors' and the train step's figures."""
    import zipfile

    pkg_log = logging.getLogger("terra_gan_tpu_torch")
    log = LogRecords()
    pkg_log.addHandler(log)
    n_tiles = TRAIN_MODE_SIDE ** 2
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_mode_") as tmp, \
                contextlib.chdir(tmp):
            t0 = time.perf_counter()
            zip_path = digimap_zip(Path("data/zips"), TRAIN_MODE_SIDE, TRAIN_MODE_RGB)
            zip_s = time.perf_counter() - t0
            Path("config.yaml").write_text(TRAIN_MODE_CONFIG.format(batch=TRAIN_MODE_BATCH))
            Path("drill.yaml").write_text(TRAIN_MODE_CONFIG.format(batch=TRAIN_MODE_DRILL_BATCH))
            cfg = Config.from_dict(yaml_lite.loads(Path("config.yaml").read_text()))
            seed_state, _ = train_state(SEED + 30, dev)
            export_pth("seed_master.pth", seed_state, 0, cfg.raw)
            seed_g = g_params(seed_state)
            del seed_state

            # the main path: the CLI's train mode, its ingest's detectors watched
            argv = ["--mode", "train", "--config", "config.yaml", "--input_model",
                    "seed_master.pth"]
            torch.cuda.synchronize()
            reset_counts(counters)
            t0 = time.perf_counter()
            with watched_detectors() as calls:
                code = main_pipeline.main(argv)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = read_counts(counters)
            ingest_s = ingest_seconds(log.records)

            proc = Path("data/processed") / TRAIN_MODE_GRID
            raw_png = sorted((proc / "raw").glob(f"{TRAIN_MODE_GRID[:2].lower()}????.png"))
            raw_mask = sorted((proc / "raw").glob("*_mask_resized.png"))
            mapping = json.loads((proc / "metadata" / "split_mapping.json").read_text())
            want_split = {f"{x},{y}": checkerboard_split(x, y, 0, 0)
                          for x in range(TRAIN_MODE_SIDE) for y in range(TRAIN_MODE_SIDE)}
            counts = {s: sum(v == s for v in mapping.values()) for s in ("train", "val", "test")}
            split_files = {s: len(list((proc / s / "images").iterdir())) for s in counts}
            master = Path("ckpts/master_checkpoint.pth")
            copies = sorted(Path("ckpts").glob("master_checkpoint_*.pth"))
            reports = sorted(Path("ckpts").glob("training_metrics_*.json"))
            copy_is_master = bool(copies) and copies[0].read_bytes() == master.read_bytes()
            report = json.loads(reports[0].read_text()) if reports else {}
            fresh, _ = train_state(SEED + 32, dev)
            fresh, extra = import_pth(master, fresh)  # strict
            master_step = fresh.step

            # the kernels at every batch this run and the drill give them
            batches = set().union(*(batch_sizes(counts[s], bs) for s in ("train", "val")
                                    for bs in (TRAIN_MODE_BATCH, TRAIN_MODE_DRILL_BATCH)))
            hold_path_batches(fresh.generator, split_tiles(proc, ("val", "train")), batches, dev)

            # the train step alone on a batch of 8 ingested tiles on the card
            step_fn = make_train_step(LoopConfig.from_training(cfg.training).loss_config())
            vgg = init_vgg(torch.Generator().manual_seed(0), dev)
            tiles = split_tiles(proc)
            batch = {k: torch.from_numpy(v[:TRAIN_MODE_BATCH]).to(dev) for k, v in tiles.items()}
            fresh.generator.train()
            step_fn(fresh, batch, vgg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            for _ in range(3):
                step_fn(fresh, batch, vgg)
            torch.cuda.synchronize()
            ms_step = (time.perf_counter() - t1) / 3 * 1e3
            peak = torch.cuda.max_memory_allocated()
            del fresh, vgg, batch, tiles

            # the detectors on the card against the same detectors on the CPU
            pipeline = MaskPipeline(cfg.mask_processing, device=dev)
            with zipfile.ZipFile(zip_path) as zf:
                first = min(n for n in zf.namelist() if n.endswith(".jpg"))
                tile = read_bgr(io.BytesIO(zf.read(first)))
            on_card = pipeline.process_image(tile)
            t0 = time.perf_counter()
            on_cpu = MaskPipeline(cfg.mask_processing, device="cpu").process_image(tile)
            cpu_s = time.perf_counter() - t0
            differing = {k.value: int(np.count_nonzero(on_card[k] != on_cpu[k]))
                         for k in on_card}
            a, b = on_card[MaskType.COMBINED] == 0, on_cpu[MaskType.COMBINED] == 0
            combined_iou = np.count_nonzero(a & b) / max(np.count_nonzero(a | b), 1)

            # Digimap's native 25 cm tile through MaskPipeline
            big = read_bgr(io.BytesIO(jpeg(aerial_tile(np.random.default_rng(SEED + 31),
                                                       NATIVE_RGB))))
            big_masks, big_ms = detector_ms(pipeline, big)

            # the drill: the same command at batch 3, preempted after one
            # step, then run again: it resumes from preempted.pth
            drill = ["--mode", "train", "--config", "drill.yaml", "--input_model",
                     "seed_master.pth"]
            t0 = time.perf_counter()
            os.environ[FAULT_ENV] = TRAIN_MODE_FAULT
            try:
                drill_code = main_pipeline.main(drill)
            finally:
                del os.environ[FAULT_ENV]
            preempted = Path("ckpts/preempted.pth")
            left = preempted.exists()
            drill_step, drill_extra, trained = 0, {}, False
            if left:
                pre, drill_extra = import_pth(preempted, train_state(SEED + 33, dev)[0])
                drill_step = pre.step
                trained = any(not torch.equal(v, seed_g[k]) for k, v in g_params(pre).items())
                del pre
            n_log = len(log.records)
            resume_code = main_pipeline.main(drill)
            drill_s = time.perf_counter() - t0
            resumed = any("resuming from preempted checkpoint" in r.getMessage()
                          for r in log.records[n_log:])
            gone = not preempted.exists()
            last = json.loads(sorted(Path("ckpts").glob("training_metrics_*.json"))[-1].read_text())
            resumed_hist = last["metrics"][TRAIN_MODE_GRID]["history"]
            resumed_steps = sum(r["steps"] for r in resumed_hist)
            resumed_master_step = import_pth(master, train_state(SEED + 35, dev)[0])[0].step
    finally:
        pkg_log.removeHandler(log)
        for h in logging.root.handlers[:]:  # the CLI's log file lived in tmp
            logging.root.removeHandler(h)
            h.close()

    errors = log.errors()
    hist = report.get("metrics", {}).get(TRAIN_MODE_GRID, {}).get("history", [{}])
    steps, val_fwd = hist[0].get("steps", 0), math.ceil(counts["val"] / TRAIN_MODE_BATCH)
    losses = [hist[0].get(k, float("nan")) for k in ("g_loss", "d_loss", "val_g_loss",
                                                     "val_d_loss")]
    # the first tile's calls include the detectors' first use on the card
    per_tile = {k.value: statistics.mean(ms for ms, _ in v[1:]) for k, v in calls.items()}
    empty = {k.value: sum(px == 0 for _, px in calls[k]) for k in DETECTED}
    line("train_mode_ingest", card=repr(card), tiles=n_tiles, rgb_px=TRAIN_MODE_RGB,
         seconds=f"{ingest_s:.3f}", tiles_per_s=f"{n_tiles / ingest_s:.3f}",
         detector_ms_per_tile={k: f"{v:.2f}" for k, v in per_tile.items()},
         first_tile_ms={k.value: f"{v[0][0]:.2f}" for k, v in calls.items()},
         detector_calls={k.value: len(v) for k, v in calls.items()}, empty_masks=empty,
         card_vs_cpu_differing_pixels=differing,
         card_vs_cpu_combined_iou=f"{combined_iou:.6f}", cpu_detectors_s=f"{cpu_s:.2f}",
         zip_s=f"{zip_s:.2f}")
    line("train_mode_native_tile", card=repr(card), rgb_px=NATIVE_RGB,
         detector_ms={k: f"{v:.2f}" for k, v in big_ms.items()},
         total_ms=f"{sum(big_ms.values()):.2f}",
         detected_px={k.value: int(np.count_nonzero(big_masks[k])) for k in DETECTED})
    line("train_mode", card=repr(card), exit=code, seconds=f"{run_s:.2f}",
         raw_png=len(raw_png), masks=len(raw_mask), split=counts, split_files=split_files,
         steps=steps, g_loss=f"{losses[0]:.5f}", d_loss=f"{losses[1]:.5f}",
         val_g_loss=f"{losses[2]:.5f}", val_d_loss=f"{losses[3]:.5f}",
         master_epoch=extra.get("epoch"), master_step=master_step,
         vgg=extra.get("vgg_weights_provenance"), copies=len(copies), metrics_json=len(reports),
         k1_fwd_launches=launches["upsample2x_fwd"], k1_bwd_launches=launches["upsample2x_bwd"],
         k2_launches=launches["fused_pconv_eval"], k3_launches=launches["fused_decoder_tail"],
         pack_launches=launches["pack_pconv_weights"],
         k2_train_launches=launches["fused_pconv_train"],
         k2_variants={v: launches[f"fused_pconv_eval.{v}"] for v in fused_pconv_eval.variants},
         held_batches=sorted(batches), ms_per_step=f"{ms_step:.2f}", batch=TRAIN_MODE_BATCH,
         samples_per_s=f"{1e3 * TRAIN_MODE_BATCH / ms_step:.2f}",
         peak_mem_gib=f"{peak / 2**30:.2f}")
    line("train_mode_drill", fault=TRAIN_MODE_FAULT, batch=TRAIN_MODE_DRILL_BATCH,
         exit=drill_code, preempted_pth=left, preempted_epoch=drill_extra.get("epoch"),
         preempted_parent=drill_extra.get("parent"), preempted_step=drill_step,
         preempted_trained=trained, resume_exit=resume_code, resumed_from_preempted=resumed,
         preempted_pth_removed=gone, resumed_epochs=[r["epoch"] for r in resumed_hist],
         resumed_steps=resumed_steps, resumed_master_step=resumed_master_step,
         errors_logged=len(errors), seconds=f"{drill_s:.2f}")
    require(not errors, f"train_mode: errors logged: {errors[:5]}")
    require(all(len(v) == n_tiles for v in calls.values()),
            f"train_mode: detector calls {[len(v) for v in calls.values()]} for {n_tiles} tiles")
    require(not any(empty.values()), f"train_mode: a detector found nothing on a tile: {empty}")
    require(all(v == 0 for v in differing.values()) or combined_iou >= DETECTOR_IOU_TOL,
            f"train_mode: card and CPU detectors differ {differing}, IoU {combined_iou}")
    require(all(np.count_nonzero(big_masks[k]) for k in DETECTED),
            "train_mode: a detector found nothing on the native-size tile")
    require(code == 0, f"train_mode: the CLI exited {code}")
    require(len(raw_png) == len(raw_mask) == n_tiles,
            f"train_mode: {len(raw_png)} raw PNGs and {len(raw_mask)} masks")
    require(mapping == want_split and split_files == counts,
            f"train_mode: split {mapping} is not the checkerboard's, or its files {split_files}")
    require(len(copies) == 1 and len(reports) == 1 and copy_is_master,
            "train_mode: the master checkpoint, its timestamped copy or the metrics JSON")
    require(report.get("successful") == [TRAIN_MODE_GRID] and extra.get("epoch") == 0,
            f"train_mode: metrics {report.get('successful')}, master epoch {extra.get('epoch')}")
    require(all(math.isfinite(v) for v in losses), f"train_mode: losses {losses}")
    require(steps == 1 and val_fwd == 1 and master_step == steps,
            f"train_mode: {steps} steps, {val_fwd} val forwards, master at step {master_step}")
    want = {"upsample2x_fwd": 7 * steps + 6 * val_fwd, "upsample2x_bwd": 7 * steps,
            "fused_pconv_eval": 13 * val_fwd, "fused_decoder_tail": val_fwd,
            "pack_pconv_weights": val_fwd + steps, "fused_pconv_train": 14 * steps}
    require(all(launches[k] == v for k, v in want.items()),
            f"train_mode: launches {launches}, want {want}")
    require_k2_variants("train_mode", launches, val_fwd)
    require(drill_code == main_pipeline.PREEMPTED_EXIT and left
            and drill_extra.get("preempted") and drill_extra.get("epoch") == 0
            and drill_step == 1 and trained,
            f"train_mode: the drill exited {drill_code}, preempted.pth {left} {drill_extra}, "
            f"at step {drill_step}, trained {trained}")
    # the resumed run starts from preempted.pth's state: its master's step
    # counts that state's step (the seed master's is 0)
    require(resume_code == 0 and resumed and gone
            and [r["epoch"] for r in resumed_hist] == [0] and resumed_steps == 2
            and resumed_master_step == drill_step + resumed_steps,
            f"train_mode: the resume exited {resume_code}, resumed {resumed}, removed {gone}, "
            f"history {resumed_hist}, master at step {resumed_master_step}")
    return launches


# the human_guided phase: a grid's 7 test tiles at 512^2, one annotation a
# tile through the port's portal, the fine-tune at batch 5 (batches of 5
# and 2) for 2 epochs from a seeded full-width master; the drill runs one
# epoch without the portal (two batches: it preempts after one step)
HG_GRID, HG_TILES, HG_BATCH, HG_EPOCHS = "NJ05", 7, 5, 2
HG_SECRET = "chip-smoke-portal-secret"
HG_USER = "c0ffee"  # the annotator page's user hash
HG_FAULT = "preempt@0:1"
HG_CONFIG = """\
# the human_guided phase's config: full width, 512^2, the full loss
training:
  modes:
    human_guided:
      epochs: {epochs}
      batch_size: 5
evaluation:
  checkpoint_dir: ckpts
experiment_tracking:
  enabled: false
data:
  processed_dir: data/processed
  output_dir: data/output
  image_size: 512
"""


class QuietWSGI(WSGIRequestHandler):
    def log_message(self, *args):
        pass


@contextlib.contextmanager
def timed_fetches():
    """Every PortalClient.fetch_annotations call while open: (seconds, files)."""
    calls = []
    real = PortalClient.fetch_annotations

    def fetch(self, *args, **kw):
        t0 = time.perf_counter()
        out = real(self, *args, **kw)
        calls.append((time.perf_counter() - t0, len(out or [])))
        return out

    PortalClient.fetch_annotations = fetch
    try:
        yield calls
    finally:
        PortalClient.fetch_annotations = real


def save_annotations(url: str, names, masks) -> None:
    """One annotation a portal image, posted to /save_annotation as the
    annotator's page posts it: a PNG data URL, the image's name, a user hash."""
    from PIL import Image

    for name, m in zip(names, masks):
        buf = io.BytesIO()
        Image.fromarray(m).save(buf, format="PNG")
        body = json.dumps({"image_name": name, "user_hash": HG_USER,
                           "mask": "data:image/png;base64,"
                           + base64.b64encode(buf.getvalue()).decode()}).encode()
        req = urllib.request.Request(f"{url}/save_annotation", data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            require(resp.status == 200, f"human_guided: /save_annotation gave {resp.status}")


def human_masks(n: int, size: int, seed: int) -> np.ndarray:
    """0/255 human annotations: a few rectangles a tile, as drawn strokes."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, size, size), np.uint8)
    for i in range(n):
        for _ in range(3):
            y0, x0 = rng.integers(0, size - 64, 2)
            out[i, y0 : y0 + rng.integers(8, 64), x0 : x0 + rng.integers(8, 64)] = 255
    return out


def phase_human_guided(dev, counters, card: str):
    """The CLI's --mode human_guided_train on the card through the port's
    portal: upload, annotate, fetch, match, fine-tune, the human-guided
    master, the portal's cleanup; K1 at the run's batches and one HG step's
    gradients against torch's upsample; the step's figures; the drill."""
    from PIL import Image

    kernels = counters[:6]  # the model's kernels, not the probes
    names = [f"{HG_GRID[:2].lower()}09{50 + i}" for i in range(HG_TILES)]
    imgs, masks = dsm_tiles(HG_TILES, SIZE, SEED + 40)
    humans = human_masks(HG_TILES, SIZE, SEED + 41)
    pkg_log = logging.getLogger("terra_gan_tpu_torch")
    log = LogRecords()
    pkg_log.addHandler(log)
    server = None
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_hg_") as tmp, contextlib.chdir(tmp):
            split = Path("data/processed") / HG_GRID / "test"
            colored = Path("data/output") / HG_GRID / "colored"
            for i, name in enumerate(names):
                for path, arr in ((split / "images" / f"{name}.png", imgs[i, ..., 0]),
                                  (split / "masks" / f"{name}_mask_resized.png", masks[i, ..., 0]),
                                  (colored / f"{name}_inpainted_colored.png", imgs[i, ..., 0])):
                    path.parent.mkdir(parents=True, exist_ok=True)
                    Image.fromarray(arr).save(path)
            seed_g = init_generator(WIDTH, torch.Generator().manual_seed(SEED + 42), "cpu")
            seed_sd = {k: v.clone() for k, v in seed_g.state_dict().items()}
            Path("ckpts").mkdir()
            torch.save({"epoch": 0, "generator_state_dict": seed_sd}, "ckpts/master_checkpoint.pth")

            # the portal: the port's WSGI server in a thread, JWT bearer auth
            app = create_portal_app("portal/images", "portal/annotations", secret_key=HG_SECRET)
            server = make_wsgi_server("127.0.0.1", 0, app, handler_class=QuietWSGI)
            threading.Thread(target=server.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{server.server_port}"
            token = jwt_auth.encode({"sub": "chip-smoke"}, HG_SECRET, expires_in=3600)
            portal_yaml = f'portal:\n  base_url: "{url}"\n  api_key: "{token}"\n'
            Path("config.yaml").write_text(HG_CONFIG.format(epochs=HG_EPOCHS) + portal_yaml)
            Path("drill.yaml").write_text(HG_CONFIG.format(epochs=1))
            cfg = Config.from_dict(yaml_lite.loads(Path("config.yaml").read_text()))
            t0 = time.perf_counter()
            require(upload_results(HG_GRID, cfg), "human_guided: upload_results failed")
            uploaded = sorted(os.listdir("portal/images"))
            save_annotations(url, uploaded, humans)
            annotate_s = time.perf_counter() - t0
            status = PortalClient(url, token).get_annotation_status(HG_GRID)
            # the annotator's page and its script, as a browser loads them
            for route, name in (("/", "index.html"), ("/static/annotator.js", "annotator.js")):
                got, body = http_get(url + route)
                require(got == 200 and body == (PORTAL_STATIC / name).read_text(),
                        f"human_guided: {route} did not serve static/{name}")

            # the main path: the CLI's human-guided mode under EXPERIMENT_MODE
            argv = ["--mode", "human_guided_train", "--grid", HG_GRID, "--config", "config.yaml"]
            os.environ["EXPERIMENT_MODE"] = "true"
            try:
                torch.cuda.synchronize()
                reset_counts(counters)
                t0 = time.perf_counter()
                with timed_fetches() as fetches:
                    code = main_pipeline.main(argv)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
                launches = read_counts(counters)
            finally:
                del os.environ["EXPERIMENT_MODE"]
            portal_left = sorted(os.listdir("portal/annotations"))
            fetched = sorted(os.listdir(Path("data/output") / HG_GRID / "human_annotation_masks"))
            stamped = sorted(Path("ckpts").glob("master_model_human_guided_*.pth"))
            master = torch.load("ckpts/master_checkpoint.pth", map_location="cpu",
                                weights_only=True)
            G = load_generator("ckpts/master_checkpoint.pth", dev)  # strict
            changed = any(not torch.equal(v.cpu(), seed_sd[k]) for k, v in G.state_dict().items())
            epoch_losses = [torch.load(Path("ckpts/human_guided") / f"generator_epoch_{e}.pth",
                                       weights_only=True)["loss"] for e in range(HG_EPOCHS)]

            # one HG step's gradients through K1 against torch's own upsample
            pairs = match_human_and_system_masks(HG_GRID, cfg)
            ds = DirectMatchDataset(pairs, size=SIZE)
            items = [ds[i] for i in range(HG_BATCH)]
            batch = {k: torch.from_numpy(np.stack([it[k] for it in items])).to(dev)
                     for k in ("image", "mask", "human_mask")}
            vgg = init_vgg(torch.Generator().manual_seed(0), dev)  # the CLI's seeded VGG
            loss_cfg = hg_loss_config(cfg)
            G.train()
            snapshot = copy.deepcopy(G.state_dict())

            def hg_grads(upsample, stage=fused_pconv_eval):
                G.load_state_dict(snapshot)

                def objective(forward):
                    real, mask = batch["image"], batch["mask"]
                    gen = (forward or G)(real * mask, mask)
                    return human_guided_loss(gen, real, mask, batch["human_mask"], vgg,
                                             loss_cfg)[0]

                return upsample_grads(G, objective, upsample, stage)

            grad_launches, up_shape, up, blocks = grads_against_plain(kernels, hg_grads)
            grad_launches = {fn.__name__: n for fn, n in zip(kernels, grad_launches)}
            worst = {k: max(b.values()) for k, b in blocks.items()}

            # K1 against its plain version at each batch the run gave it
            gen = torch.Generator().manual_seed(SEED + 43)
            held = {b: k1_errors(WIDTH, b, gen, dev) for b in sorted(batch_sizes(HG_TILES,
                                                                                  HG_BATCH))}

            # the HG step alone on a batch of 5 on the card
            G.load_state_dict(snapshot)
            step = HumanGuidedTrainer(cfg).make_step(
                G, adam(G.parameters(), cfg.training.human_guided.learning_rate))
            step(batch, vgg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            for _ in range(3):
                step(batch, vgg)
            torch.cuda.synchronize()
            ms_step = (time.perf_counter() - t1) / 3 * 1e3
            peak = torch.cuda.max_memory_allocated()
            del G, vgg, batch, snapshot, step

            # the drill: one epoch from the HG master, preempted after its
            # first step, then run again: it resumes from preempted.pth
            drill = ["--mode", "human_guided_train", "--grid", HG_GRID, "--config", "drill.yaml"]
            t0 = time.perf_counter()
            os.environ[FAULT_ENV] = HG_FAULT
            try:
                drill_code = main_pipeline.main(drill)
            finally:
                del os.environ[FAULT_ENV]
            preempted = Path("ckpts/human_guided/preempted.pth")
            left = preempted.exists()
            pre = torch.load(preempted, weights_only=True) if left else {}
            pre_steps = int(pre["model_state_dict"]["enc1.bn.num_batches_tracked"]) if left else 0
            resume_code = main_pipeline.main(drill)
            drill_s = time.perf_counter() - t0
            resumed = torch.load("ckpts/master_checkpoint.pth", weights_only=True)
            resumed_steps = int(resumed["generator_state_dict"]["enc1.bn.num_batches_tracked"])
            gone = not preempted.exists()
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        pkg_log.removeHandler(log)
        for h in logging.root.handlers[:]:  # the CLI's log file lived in tmp
            logging.root.removeHandler(h)
            h.close()

    steps = HG_EPOCHS * math.ceil(HG_TILES / HG_BATCH)
    master_steps = int(master["generator_state_dict"]["enc1.bn.num_batches_tracked"])
    keys = {"generator_state_dict", "human_guided", "source_model", "resumed_from_preemption",
            "grid_square", "best_loss", "config", "vgg_weights_provenance", "architecture"}
    line("human_guided", card=repr(card), exit=code, tiles=HG_TILES, batch=HG_BATCH,
         epochs=HG_EPOCHS, steps=steps, seconds=f"{run_s:.2f}",
         fetch_s=[f"{t:.4f}" for t, _ in fetches], annotations=[n for _, n in fetches],
         annotate_s=f"{annotate_s:.2f}", portal_status=status,
         epoch_losses=[f"{v:.6f}" for v in epoch_losses], best_loss=master.get("best_loss"),
         master_keys=sorted(master), stamped=len(stamped), master_steps=master_steps,
         weights_changed=changed, portal_left=len(portal_left), fetched=len(fetched),
         vgg=master.get("vgg_weights_provenance"),
         k1_fwd_launches=launches["upsample2x_fwd"], k1_bwd_launches=launches["upsample2x_bwd"],
         k1_fwd_per_step=launches["upsample2x_fwd"] / steps,
         k1_bwd_per_step=launches["upsample2x_bwd"] / steps,
         k2_launches=launches["fused_pconv_eval"], k3_launches=launches["fused_decoder_tail"],
         pack_launches=launches["pack_pconv_weights"],
         k2_train_launches=launches["fused_pconv_train"],
         k2_train_per_step=launches["fused_pconv_train"] / steps, ms_per_step=f"{ms_step:.2f}",
         samples_per_s=f"{1e3 * HG_BATCH / ms_step:.2f}", peak_mem_gib=f"{peak / 2**30:.2f}")
    line("human_guided_grad", batch=HG_BATCH, up_grad="x".join(map(str, up_shape)),
         kernel_launches=grad_launches,
         **{f"{k}_up_rel_l2": f"{v:.3e}" for k, v in up.items()},
         **{f"{k}_block_rel_l2_max": f"{v:.3e}" for k, v in worst.items()})
    for b, (fwd_err, bwd_rel) in held.items():
        line("human_guided_batch", batch=b, k1_fwd_max_abs_err=f"{fwd_err:.3e}",
             k1_bwd_rel_max=f"{bwd_rel:.3e}")
    line("human_guided_drill", fault=HG_FAULT, exit=drill_code, preempted_pth=left,
         preempted_epoch=pre.get("epoch"), preempted_steps=pre_steps, resume_exit=resume_code,
         resumed_from_preemption=resumed.get("resumed_from_preemption"),
         resumed_steps=resumed_steps, preempted_pth_removed=gone, seconds=f"{drill_s:.2f}")
    require(code == 0, f"human_guided: the CLI exited {code}")
    require(uploaded == [f"{HG_GRID}_{n}_inpainted_colored.png" for n in names]
            and status == {"grid_square": HG_GRID, "total_images": HG_TILES,
                           "annotated_images": HG_TILES, "completed": True},
            f"human_guided: the portal held {uploaded}, status {status}")
    require(len(fetches) == 1 and fetches[0][1] == HG_TILES and len(fetched) == HG_TILES,
            f"human_guided: fetched {fetches}, {len(fetched)} files")
    require(set(master) == keys and master["human_guided"] is True
            and master["architecture"] == "pconv_unet"
            and master["grid_square"] == HG_GRID and len(stamped) == 1
            and master["resumed_from_preemption"] is False
            and master["source_model"] == str(Path("ckpts/master_checkpoint.pth")),
            f"human_guided: the master {sorted(master)}, {len(stamped)} stamped copies")
    require(changed and master_steps == steps,
            f"human_guided: weights changed {changed}, BatchNorm at {master_steps} steps")
    require(all(math.isfinite(v) and v > 0 for v in epoch_losses)
            and master["best_loss"] == min(epoch_losses),
            f"human_guided: epoch losses {epoch_losses}, best {master['best_loss']}")
    require(not portal_left, f"human_guided: the portal still holds {portal_left}")
    want = {"upsample2x_fwd": 7 * steps, "upsample2x_bwd": 7 * steps, "fused_pconv_eval": 0,
            "fused_decoder_tail": 0, "pack_pconv_weights": steps, "fused_pconv_train": 14 * steps}
    require(all(launches[k] == v for k, v in want.items()),
            f"human_guided: launches {launches}, want {want}")
    require(grad_launches == {**want, "upsample2x_fwd": 7, "upsample2x_bwd": 7,
                              "pack_pconv_weights": 1, "fused_pconv_train": 14},
            f"human_guided: the gradient's kernel path launched {grad_launches}")
    require(up["kernel"] <= GRAD_TOL and worst["kernel"] <= GRAD_TOL,
            f"human_guided: gradients off by {up['kernel']} (upsample input), "
            f"{worst['kernel']} (a block)")
    require(up["tf32"] > GRAD_TOL and worst["tf32"] > GRAD_TOL,
            f"human_guided: the gradient checks pass the TF32 plain path ({up['tf32']}, "
            f"{worst['tf32']}): they see nothing")
    for b, (fwd_err, bwd_rel) in held.items():
        require(fwd_err <= K1_F32_ABS_TOL and bwd_rel <= K1_BWD_REL_TOL,
                f"human_guided: K1 at batch {b}: fwd err {fwd_err}, bwd rel err {bwd_rel}")
    require(drill_code == main_pipeline.PREEMPTED_EXIT and left and pre.get("preempted")
            and pre.get("epoch") == 0 and pre_steps == steps + 1,
            f"human_guided: the drill exited {drill_code}, preempted.pth {left}, "
            f"{pre_steps} steps")
    # the resumed run starts from preempted.pth and runs its one epoch again
    require(resume_code == 0 and gone and resumed.get("resumed_from_preemption") is True
            and resumed_steps == pre_steps + math.ceil(HG_TILES / HG_BATCH),
            f"human_guided: the resume exited {resume_code}, removed {gone}, "
            f"{resumed_steps} steps")
    return launches


def main() -> None:
    kind, card = phase_env()
    phase_build()

    dev = torch.device("cuda", 0)
    model = init_generator(WIDTH, torch.Generator().manual_seed(SEED), dev)
    figures = {"fused_pconv_eval": phase_k2(model, dev),
               "fused_pconv_train": phase_k2_train(model, dev),
               "upsample2x_fwd": phase_k1(model, dev),
               "upsample2x_bwd": phase_k1_bwd(model, dev), "pack_pconv_weights": phase_pack(model),
               "ffc_local": phase_ffc(dev), **phase_ffc_backward(dev)}
    counters = (fused_pconv_eval, upsample2x_fwd, upsample2x_bwd, fused_decoder_tail,
                pack_pconv_weights, fused_pconv_train)
    runs = [phase_slice(model, dev, counters)]
    phase_files(model, dev, counters)
    figures["fused_decoder_tail"] = phase_k3(model, dev)
    del model
    # launches: the main paths' runs, the inference slice, the train epoch,
    # Big-LaMa's GAN step and evaluate, serving, the doctor, the CLI's
    # evaluate, its train mode and its human-guided mode
    runs.append(phase_train(dev, counters))
    runs.append(phase_lama(dev))
    phase_train_grad(dev, counters)
    runs.append(phase_serve(dev, counters))
    figures.update(phase_probes(dev))
    runs.append(phase_doctor(counters + PROBES))
    runs.append(phase_cli(dev, counters + PROBES))
    runs.append(phase_train_mode(dev, counters + PROBES, card))
    runs.append(phase_human_guided(dev, counters + PROBES, card))
    ffc = (ffc_local, ffc_local_dgrad, ffc_local_wgrad)
    launches = dict.fromkeys(read_counts(counters + PROBES + ffc), 0)
    for run in runs:
        for name, n in run.items():
            launches[name] += n

    sources = {
        "fused_pconv_eval": ("pconv_eval.cu", "terra_gan_tpu/ops/pallas/pconv_kernel.py:297"),
        # K2's train variant: the JAX package's train stage is the plain conv
        # (terra_gan_tpu/ops/pallas/pconv_kernel.py:28), no TPU kernel
        "fused_pconv_train": ("pconv_eval.cu", "none"),
        "upsample2x_fwd": ("upsample2x.cu", "terra_gan_tpu/ops/pallas/upsample_kernel.py:198"),
        "upsample2x_bwd": ("upsample2x.cu", "terra_gan_tpu/ops/pallas/upsample_kernel.py:204"),
        "fused_decoder_tail": ("decoder_tail.cu", "terra_gan_tpu/ops/pallas/tail_kernel.py:226"),
        # part of K2's port: its weight planes (the TPU kernel reads the weight as it is)
        "pack_pconv_weights": ("pconv_eval.cu", "terra_gan_tpu/ops/pallas/pconv_kernel.py:297"),
        # Big-LaMa's block FFCs: the JAX package has no Big-LaMa
        "ffc_local": ("ffc_conv.cu", "none"),
        "ffc_local_dgrad": ("ffc_conv.cu", "none"),
        "ffc_local_wgrad": ("ffc_conv.cu", "none"),
        **{name: ("probes.cu", f"scripts/probe_mosaic.py:{ln}")
           for name, ln in PROBE_REPLACES.items()},
    }
    require(all(launches[name] > 0 for name in sources),
            f"a kernel of the main paths was never launched there: {launches}")
    peaks = {"fused_pconv_eval": "k2", "fused_pconv_train": "k2", "fused_decoder_tail": "k3",
             "ffc_local": "ffc", "ffc_local_dgrad": "ffc", "ffc_local_wgrad": "ffc"}
    kernels = [
        {"name": name, "route": "cuda", "source": f"terra_gan_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[name], **figures[name],
         "peak": PEAKS[peaks.get(name, "fp32")]}
        for name, (src, replaces) in sources.items()
    ]
    wrappers = {fn.__name__: fn for fn in counters + PROBES + ffc}
    for k in kernels:  # K2's, P2's and P4's launches by variant
        wrapper = wrappers[k["name"]]
        if hasattr(wrapper, "variants"):
            k["variants"] = {v: launches[f"{k['name']}.{v}"] for v in wrapper.variants}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
