"""The ``lama.train-b16`` cell on the CPU at a small size: its driver reads
correct, the control and the planted faults each fail a limit, the
operation and parameter counts of ``work_lama`` against a count by hand,
and none of its modules pulls in JAX."""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from torch_bench import harness, work_lama

ROOT = Path(__file__).resolve().parents[2]
CELL = "lama.train-b16"
# ngf 8, 2 blocks at 64 channels (ratio 0.75: 16 local, 48 global), 64^2 tiles, batch 4
SMALL = {"config": {"ngf": 8, "n_blocks": 2, "discriminator_width": 8, "image_size": 64,
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
    want = {"lama.mfu", "train.loader_wait_ms"} if trace else {"train_samples_per_s", "setup_s"}
    # on the CPU no device metric is read: the trace has no device operation
    assert set(res["metrics"]) == want


@pytest.mark.parametrize("control,fault", [("tf32", None), (None, "half_batch"),
                                           (None, "unchanged")])
def test_the_control_and_the_faults_fail_a_limit(control, fault):
    res = run_small(control=control, fault=fault)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_work_lama_against_a_count_by_hand():
    # the published generator at 512^2: a block's FFC at 64^2 with 128 local
    # and 384 global channels is l2l + l2g + g2l (3x3), ST's 1x1 in, the Fourier
    # unit's 1x1 over 64 x 33 frequencies (384 channels), ST's 1x1 out
    px = 64 * 64
    ffc = 2 * px * 9 * (128 * 128 + 128 * 384 + 384 * 128) + 2 * px * 384 * 192 * 2 \
        + 2 * 64 * 33 * 384 * 384
    down = 2 * 256**2 * 9 * 64 * 128 + 2 * 128**2 * 9 * 128 * 256 + 2 * 64**2 * 9 * 256 * 512
    up = 2 * 64**2 * 9 * 512 * 256 + 2 * 128**2 * 9 * 256 * 128 + 2 * 256**2 * 9 * 128 * 64
    ends = 2 * 512**2 * 49 * (2 * 64 + 64 * 1)
    assert work_lama.forward_flops(512) == 36 * ffc + down + up + ends
    assert round(work_lama.forward_flops(512) / 1e9, 1) == 433.2
    assert round(36 * ffc / 1e9, 1) == 370.3
    by_part = work_lama.forward_flops_by_part(512)
    assert by_part == {"ends": ends, "down": down, "blocks": 36 * ffc, "up": up}
    ffc_params = 9 * (128 * 128 + 128 * 384 + 384 * 128) + 384 * 192 + 384 * 384 + 192 * 384
    params = (36 * ffc_params + 2 * 64 * 49 + 9 * (64 * 128 + 128 * 256 + 256 * 512)
              + 9 * (512 * 256 + 256 * 128 + 128 * 64) + 256 + 128 + 64 + 64 * 49 + 1)
    assert work_lama.parameters() == params == 50_882_177
    # a GAN sample: G 3x (less its first conv's input gradient), VGG and D as work.py counts
    assert round(work_lama.train_step_flops(512) / 1e12, 2) == 1.71


def test_its_modules_pull_in_no_jax():
    script = (
        "import sys; sys.path.insert(0, '.');"
        "from torch_bench import phases, work_lama; from torch_bench.drivers import lama_train;"
        "from torch_bench.reference import lama; import terra_gan_tpu_torch.models.lama;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'terra_gan_tpu' or m.startswith('terra_gan_tpu.')];"
        "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


def test_the_reference_imports_nothing_of_the_program():
    source = (ROOT / "torch_bench" / "reference" / "lama.py").read_text()
    assert "terra_gan_tpu" not in source and "jax" not in source
