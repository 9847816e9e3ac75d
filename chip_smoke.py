"""Drive the PyTorch port's 512^2 inference and training paths once on one CUDA card.

    python3 chip_smoke.py

Phases, one line of figures each (any failure raises and exits nonzero):
  1. environment: card, power limit, torch and CUDA versions, TF32 off;
  2. build: the kernels of terra_gan_tpu_torch/csrc with nvcc (sm_90a);
  3. K2 fused_pconv_eval against its plain version at the 14 stage
     geometries of the full-width (base_width=64) 512^2 PConvUNet, batch 2;
  4. K1 upsample2x_fwd against its plain version at the 7 decoder
     shapes, fp32 (torch's bits) and bf16;
  5. K1 upsample2x_bwd against torch's own upsample backward at the same
     shapes, fp32 and bf16, and the adjointness <U x, g> = <x, U^T g>;
  6. the slice: 16 synthetic uint8 DSM-like tiles through
     BatchedInpainter(chunk=8) with seeded random weights, held against
     the same model's plain path on the composite and on dec1's
     features, with the kernels' launch counts; the same feature check
     must fail the plain path run in TF32, which shows it can see an
     error of that size;
  7. files: evaluate on one PNG tile, then inpaint_directory end to end
     on a directory of 512^2 PNGs;
  8. train: the port's train() for one epoch over 24 PNG tiles at batch
     8 (3 steps of G+D with the full loss, VGG perceptual included) and
     one validation batch of 8, with seeded G, D and VGG, fp32, TF32
     off; the launch counts (K1 forward and backward 7 per step, K2 only
     in validation), the best checkpoint reloaded strictly into a fresh
     state, ms per step, samples/s and peak memory;
  9. train_grad: one batch of 8 through the G objective's forward and
     backward, once through K1 and once through torch's own upsample,
     cuDNN deterministic: the gradient at dec1's upsample input and the
     per-block weight gradients held to one bound, which the plain path
     run in TF32 must exceed.
Then a JSON line of per-kernel figures, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without CUDA it exits nonzero before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from terra_gan_tpu_torch.evaluation.inference import OUTPUT_SIZE, evaluate, inpaint_directory
from terra_gan_tpu_torch.ops.cuda._build import build_info, load_library
from terra_gan_tpu_torch.ops.cuda.pconv_kernel import (
    fold_batch_norm,
    fused_pconv_eval,
    fused_pconv_eval_plain,
)
from terra_gan_tpu_torch.config import TrainingConfig
from terra_gan_tpu_torch.ops.cuda.upsample_kernel import (
    upsample2x_bwd,
    upsample2x_bwd_plain,
    upsample2x_fwd,
    upsample2x_fwd_plain,
)
from terra_gan_tpu_torch.parallel.infer import BatchedInpainter
from terra_gan_tpu_torch.training.checkpoint import import_pth
from terra_gan_tpu_torch.training.loop import train
from terra_gan_tpu_torch.training.state import GANTrainState
from terra_gan_tpu_torch.training.step import generator_objective, make_train_step
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
# on dec1's features: fp32 sums in another order read ~3e-8 there, the
# plain path in TF32 ~3e-5 (the phase checks that it still fails)
DEC1_NRMSE_TOL = 1e-6
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
    worst_abs, ms, plain_ms = 0.0, 0.0, 0.0
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
    return worst_abs, ms, plain_ms


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
    worst_abs, ms, plain_ms = 0.0, 0.0, 0.0
    for h, c in upsample_shapes(model.base_width):
        x = torch.rand((STAGE_BATCH, h, h, c), generator=gen).to(dev)
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
        line("k1", x=f"{STAGE_BATCH}x{h}x{h}x{c}", f32_max_abs_err=f"{err:.3e}",
             bf16_max_ulps=f"{ulps:.3f}", ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}",
             bf16_ms=f"{t_kb:.4f}", bf16_plain_ms=f"{t_pb:.4f}")
        require(err <= K1_F32_ABS_TOL, f"K1 {h}x{c}: fp32 err {err}: not torch's bits")
        require(ulps <= 1.0, f"K1 {h}x{c}: bf16 off by {ulps} ulp")
        worst_abs, ms, plain_ms = max(worst_abs, err), ms + t_k, plain_ms + t_p
    return worst_abs, ms, plain_ms


def phase_k1_bwd(model, dev):
    gen = torch.Generator().manual_seed(SEED + 4)
    worst_abs, ms, plain_ms = 0.0, 0.0, 0.0
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
        line("k1_bwd", g=f"{STAGE_BATCH}x{2 * h}x{2 * h}x{c}", f32_max_abs_err=f"{err:.3e}",
             rel=f"{err / max(scale, 1e-30):.3e}", bf16_max_ulps=f"{ulps:.3f}",
             adjoint_rel=f"{adj:.3e}", ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}",
             bf16_ms=f"{t_kb:.4f}", bf16_plain_ms=f"{t_pb:.4f}")
        require(got.shape == (STAGE_BATCH, h, h, c), f"K1 bwd {h}x{c}: shape {tuple(got.shape)}")
        require(err <= K1_BWD_REL_TOL * scale, f"K1 bwd {h}x{c}: fp32 err {err} > 1e-6 * {scale}")
        require(ulps <= 1.0, f"K1 bwd {h}x{c}: bf16 off by {ulps} ulp")
        require(adj <= ADJOINT_TOL, f"K1 bwd {h}x{c}: not the adjoint of K1 fwd ({adj})")
        worst_abs, ms, plain_ms = max(worst_abs, err), ms + t_k, plain_ms + t_p
    return worst_abs, ms, plain_ms


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
def dec1_features(model):
    """Collects dec1's output features, one tensor per forward, while open."""
    feats = []
    hook = model.dec1.register_forward_hook(lambda mod, args, out: feats.append(out[0]))
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
    with dec1_features(model) as got_dec1:
        out_f = np.concatenate([o for _, o in inp_f.stream_from(iter(chunks))])
    t1 = time.perf_counter()
    out_u8 = np.concatenate([o for _, o in inp_u8.stream_from(iter(chunks))])
    t2 = time.perf_counter()
    launches = {fn.__name__: fn.launches for fn in counters}
    forwards = 2 * len(chunks)

    want_f, want_u8 = [], []
    with torch.inference_mode(), dec1_features(model) as want_dec1:
        for _, im, mk in chunks:
            x = torch.from_numpy(im.astype(np.float32) / 255.0).to(dev)
            m = torch.from_numpy((mk > 0).astype(np.float32)).to(dev)
            y = model.forward_plain(x * m, m)
            want_f.append(y.cpu().numpy())
            want_u8.append((y.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy())
    # the sensitivity control: the plain path of the last chunk in TF32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode(), dec1_features(model) as tf32_dec1:
            model.forward_plain(x * m, m)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want_f, want_u8 = np.concatenate(want_f), np.concatenate(want_u8)
    err = nrmse(out_f, want_f)
    feat_err = nrmse(torch.cat(got_dec1), torch.cat(want_dec1))
    tf32_err = nrmse(tf32_dec1[0], want_dec1[-1])
    u8_diff = int(np.abs(out_u8.astype(np.int16) - want_u8.astype(np.int16)).max())
    holes = masks == 0
    line("slice", tiles=N_TILES, chunk=CHUNK, shape="x".join(map(str, out_f.shape)),
         nrmse=f"{err:.3e}", dec1_nrmse=f"{feat_err:.3e}",
         tf32_dec1_nrmse=f"{tf32_err:.3e}", u8_max_diff=u8_diff,
         hole_mean=f"{out_f[holes].mean():.4f}", hole_std=f"{out_f[holes].std():.4f}",
         dec1_std=f"{torch.cat(want_dec1).std().item():.4f}", forwards=forwards,
         k2_launches=launches["fused_pconv_eval"], k1_launches=launches["upsample2x_fwd"],
         float_tiles_per_s=f"{N_TILES / (t1 - t0):.2f}",
         u8_tiles_per_s=f"{N_TILES / (t2 - t1):.2f}",
         peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    require(out_f.shape == (N_TILES, SIZE, SIZE, 1), f"slice: shape {out_f.shape}")
    require(np.isfinite(out_f).all(), "slice: non-finite output")
    require(err <= SLICE_NRMSE_TOL, f"slice: NRMSE {err} > {SLICE_NRMSE_TOL}")
    require(feat_err <= DEC1_NRMSE_TOL, f"slice: dec1 NRMSE {feat_err} > {DEC1_NRMSE_TOL}")
    require(tf32_err > DEC1_NRMSE_TOL,
            f"slice: the dec1 check passes the TF32 plain path ({tf32_err}): it sees nothing")
    require(u8_diff <= SLICE_U8_TOL, f"slice: uint8 off by {u8_diff} grey levels")
    require(np.array_equal(out_f[~holes], imgs[~holes].astype(np.float32) / 255.0),
            "slice: valid pixels are not copied from the input")
    require(launches["fused_pconv_eval"] == 14 * forwards,
            f"slice: K2 launched {launches['fused_pconv_eval']} times in {forwards} forwards")
    require(launches["upsample2x_fwd"] == 7 * forwards,
            f"slice: K1 launched {launches['upsample2x_fwd']} times in {forwards} forwards")
    require(launches["upsample2x_bwd"] == 0, "slice: K1 bwd launched in inference")
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
        require(one_launches == (14, 7, 0), f"files: evaluate launched {one_launches}")
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
    cfg = TrainingConfig(epochs=1, batch_size=TRAIN_BATCH)
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
         train_seconds=f"{seconds:.2f}", ms_per_step=f"{ms_step:.2f}",
         samples_per_s=f"{1e3 * TRAIN_BATCH / ms_step:.2f}",
         peak_mem_gib=f"{peak / 2**30:.2f}", reloaded=saved_ok, adam_entries=n_adam,
         g_training=state.generator.training, checkpoint_epoch=extra.get("epoch"))
    require(all(math.isfinite(v) for v in losses), f"train: non-finite losses {losses}")
    require(steps == N_TRAIN // TRAIN_BATCH and state.step == steps + 4,
            f"train: {steps} steps in the epoch, state.step {state.step}")
    require(launches["upsample2x_bwd"] == 7 * steps,
            f"train: K1 bwd launched {launches['upsample2x_bwd']} times in {steps} steps")
    require(launches["upsample2x_fwd"] == 7 * (steps + val_fwd),
            f"train: K1 fwd launched {launches['upsample2x_fwd']} times in {steps + val_fwd} forwards")
    require(launches["fused_pconv_eval"] == 14 * val_fwd,
            f"train: K2 launched {launches['fused_pconv_eval']} times: 14 per validation forward, "
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
        forward = lambda x, m: G._run(x, m, fused_pconv_eval_plain, upsample)  # noqa: E731
    hook = G.dec2.register_forward_hook(capture)
    try:
        total, *_ = generator_objective(state, batch, vgg, TrainingConfig().loss_config(),
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
    require(kernel_launches == [0, 7, 7], f"train_grad: kernel path launched {kernel_launches}")
    require(up["kernel"] <= GRAD_TOL, f"train_grad: upsample-input gradient off by {up['kernel']}")
    require(worst["kernel"] <= GRAD_TOL, f"train_grad: a block's gradient off by {worst['kernel']}")
    require(up["tf32"] > GRAD_TOL and worst["tf32"] > GRAD_TOL,
            f"train_grad: the checks pass the TF32 plain path ({up['tf32']}, "
            f"{worst['tf32']}): they see nothing")


def main() -> None:
    kind, _ = phase_env()
    phase_build()

    dev = torch.device("cuda", 0)
    model = init_generator(WIDTH, torch.Generator().manual_seed(SEED), dev)
    k2_err, k2_ms, k2_plain = phase_k2(model, dev)
    k1_err, k1_ms, k1_plain = phase_k1(model, dev)
    k1b_err, k1b_ms, k1b_plain = phase_k1_bwd(model, dev)
    counters = (fused_pconv_eval, upsample2x_fwd, upsample2x_bwd)
    launches = phase_slice(model, dev, counters)
    phase_files(model, dev, counters)
    del model
    train_launches = phase_train(dev, counters)
    phase_train_grad(dev, counters)
    # launches: the main paths' runs, the inference slice and the train epoch
    for name, n in train_launches.items():
        launches[name] += n

    kernels = [
        {"name": "fused_pconv_eval", "route": "cuda",
         "source": "terra_gan_tpu_torch/csrc/pconv_eval.cu",
         "replaces": "terra_gan_tpu/ops/pallas/pconv_kernel.py:297",
         "launches": launches["fused_pconv_eval"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
        {"name": "upsample2x_fwd", "route": "cuda",
         "source": "terra_gan_tpu_torch/csrc/upsample2x.cu",
         "replaces": "terra_gan_tpu/ops/pallas/upsample_kernel.py:198",
         "launches": launches["upsample2x_fwd"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "upsample2x_bwd", "route": "cuda",
         "source": "terra_gan_tpu_torch/csrc/upsample2x.cu",
         "replaces": "terra_gan_tpu/ops/pallas/upsample_kernel.py:204",
         "launches": launches["upsample2x_bwd"], "max_abs_err": k1b_err,
         "ms": k1b_ms, "plain_ms": k1b_plain},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
