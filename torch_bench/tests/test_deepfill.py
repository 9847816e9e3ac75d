"""The ``deepfill.train-b16`` cell on the CPU at a small size: its driver reads
correct, the control and the planted faults each fail a limit, the
readers of its per-layer metrics, the operation, byte and parameter
counts of ``work_deepfill`` against a count by hand, and none of its
modules pulls in JAX."""

import argparse
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from torch_bench import harness, work, work_deepfill

ROOT = Path(__file__).resolve().parents[2]
CELL = "deepfill.train-b16"
# cnum 8 at 128^2 (the attention over 16^2 = 256 keys), batch 4
SMALL = {"config": {"cnum": 8, "discriminator_width": 8, "image_size": 128,
                    "batch_size": {"gan": 4}},
         "traffic": {"tiles": 15}}


def run_small(control=None, fault=None, trace=0, seed=2**31 + 23):
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=1.0, trace=trace,
                              control=control, fault=fault)
    return harness.run_cell(args, time.perf_counter(), torch.device("cpu"), SMALL)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_reads_correct(trace):
    res = run_small(trace=trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 3 and res["failed"] == 0
    want = ({"deepfill.mfu", "train.loader_wait_ms"} if trace
            else {"train_samples_per_s", "setup_s"})
    # on the CPU no device metric is read: the trace has no device operation
    assert set(res["metrics"]) == want


@pytest.mark.parametrize("control,fault", [("tf32", None), (None, "half_batch"),
                                           (None, "unchanged")])
def test_the_control_and_the_faults_fail_a_limit(control, fault):
    res = run_small(control=control, fault=fault)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def _reader(name):
    return harness.load_module(ROOT / "torch_bench" / "metrics" / f"{name}.py")


def test_the_attention_readers():
    cfg = {"image_size": 512, "cnum": 48, "discriminator_width": 64}
    run = SimpleNamespace(counts={"ctx_attn_device_ms": 31.2, "ctx_attn_batch": 16.0},
                          config=cfg)
    assert _reader("deepfill.ctx_attn_device_ms").read(run) == 31.2
    bound_ms = 1e3 * work_deepfill.ctx_attn_forward_bound(16)
    assert _reader("deepfill.ctx_attn_roofline").read(run) == pytest.approx(
        100 * bound_ms / 31.2)
    parent = SimpleNamespace(counts={}, config=cfg)  # a program without the range
    assert _reader("deepfill.ctx_attn_device_ms").read(parent) is None
    assert _reader("deepfill.ctx_attn_roofline").read(parent) is None
    timed = SimpleNamespace(counts={"samples": 160}, config=cfg, window_s=10.0)
    assert _reader("deepfill.mfu").read(timed) == pytest.approx(
        100 * 16 * work_deepfill.train_step_flops(512) / work.FP32_ACCURATE_FLOPS)


def test_work_deepfill_against_a_count_by_hand():
    px = 512 * 512

    def conv(ci, co, k, div):
        return 2 * (px // div**2) * ci * co * k * k

    coarse = (conv(3, 48, 5, 1) + conv(24, 96, 3, 2) + conv(48, 96, 3, 2) + conv(48, 192, 3, 4)
              + 8 * conv(96, 192, 3, 4) + conv(96, 96, 3, 2) + conv(48, 96, 3, 2)
              + conv(48, 48, 3, 1) + conv(24, 24, 3, 1) + conv(12, 1, 3, 1))
    dilated = (conv(1, 48, 5, 1) + conv(24, 48, 3, 2) + conv(24, 96, 3, 2) + conv(48, 96, 3, 4)
               + conv(48, 192, 3, 4) + 5 * conv(96, 192, 3, 4))
    attention = (conv(1, 48, 5, 1) + conv(24, 48, 3, 2) + conv(24, 96, 3, 2)
                 + conv(48, 192, 3, 4) + 4 * conv(96, 192, 3, 4))
    merged = (conv(192, 192, 3, 4) + conv(96, 192, 3, 4) + conv(96, 96, 3, 2)
              + conv(48, 96, 3, 2) + conv(48, 48, 3, 1) + conv(24, 24, 3, 1) + conv(12, 1, 3, 1))
    length = 64 * 64
    ctx = 2 * length * length * 96 * 9 + 2 * length * length * 96 * 16
    assert work_deepfill.forward_flops_by_part(512) == {
        "coarse": coarse, "refine": dilated + attention + merged, "ctx_attn": ctx}
    assert work_deepfill.forward_flops(512) == coarse + dilated + attention + merged + ctx
    assert round(work_deepfill.forward_flops(512) / 1e9, 1) == 278.1
    assert round(ctx / 1e9, 1) == 80.5
    # a GAN sample: G 3x (less conv1's input gradient), VGG and D as work.py counts
    d = work.discriminator_flops(64, 512)
    by_hand = (3 * work_deepfill.forward_flops(512) - conv(3, 48, 5, 1)
               + 3 * sum(work.vgg_flops(512)) + 6 * sum(d) + sum(d) + 2 * (sum(d) - d[0]))
    assert work_deepfill.train_step_flops(512) == by_hand
    assert round(by_hand / 1e12, 2) == 1.24
    assert work_deepfill.parameters() == 4_044_842


def test_the_attention_bound_by_hand_at_a_small_shape():
    # 64^2 tiles, cnum 8: the attention at 16^2 with 16 channels, L = 8^2 = 64
    flops = 2 * 64 * 64 * 16 * (9 + 16)
    assert work_deepfill.ctx_attn_flops(64, 8) == flops
    moved = 4 * 3 * 16 * 16 * (2 * 16 + 1)  # batch 3: features in, out, the hole mask
    assert work_deepfill.ctx_attn_forward_bound(3, 64, 8) == max(
        3 * flops / work.FP32_ACCURATE_FLOPS, moved / work.HBM_BYTES_PER_S)
    # at the published size the products bound: 7.8 ms at batch 16
    assert 1e3 * work_deepfill.ctx_attn_forward_bound(16) == pytest.approx(
        16 * 80.5306368e9 / 165e9, rel=1e-9)
    assert work_deepfill.train_step_flops(64, 8, 8) == (
        3 * work_deepfill.forward_flops(64, 8) - 2 * 64 * 64 * 3 * 8 * 25
        + 3 * sum(work.vgg_flops(64)) + 7 * sum(work.discriminator_flops(8, 64))
        + 2 * (sum(work.discriminator_flops(8, 64)) - work.discriminator_flops(8, 64)[0]))


def test_its_modules_pull_in_no_jax():
    script = (
        "import sys; sys.path.insert(0, '.');"
        "from torch_bench import phases, work_deepfill;"
        "from torch_bench.drivers import deepfill_train;"
        "from torch_bench.reference import deepfill; import terra_gan_tpu_torch.models.deepfill;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'terra_gan_tpu' or m.startswith('terra_gan_tpu.')];"
        "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


def test_the_reference_imports_nothing_of_the_program():
    source = (ROOT / "torch_bench" / "reference" / "deepfill.py").read_text()
    assert "terra_gan_tpu" not in source and "jax" not in source
    assert "eye(" not in source  # the fuse by its definition, not the identity-kernel conv
