"""The yardstick's arithmetic: operations and bounds from the shapes, the
trace's busy time and idle gaps, and readers that find nothing."""

import types

import numpy as np
import pytest

from torch_bench import harness, work
from torch_bench.traffic import dsm_tiles, human_masks, poisson_schedule, tile_set


def test_forward_operations_per_tile():
    # conv multiply-adds x 2 at base 64 and 512^2 (bench.py's 93.9 rounds the same count)
    assert work.generator_forward_flops(64, 512) / 1e9 == pytest.approx(93.6336, abs=1e-3)


def test_kernel_bounds_at_batch_8():
    # K3: dec1 at the fp32-accurate rate and the final conv in fp32 (0.973 ms in the
    # kernel table); K2: 13 stages and the pack of 14 stages' weights
    assert work.k3_forward_bound(64, 512, 8) * 1e3 == pytest.approx(0.9731, abs=1e-4)
    assert work.k2_forward_bound(64, 512, 8) * 1e3 == pytest.approx(3.7063, abs=1e-3)
    # enc1 (one input channel) is bound by its bytes, the deep stages by operations
    enc1 = work.generator_convs(64, 512)[0]
    flops_s = 8 * work.conv_flops(*enc1[1:5]) / work.FP32_ACCURATE_FLOPS
    assert work.k2_stage_bound(*enc1[1:], 8) > flops_s


def test_train_step_operations():
    fwd = work.generator_forward_flops(64, 512)
    gan, hg = work.train_step_flops("gan", 64, 512), work.train_step_flops("hg", 64, 512)
    assert 3 * fwd - 1e9 < hg - 3 * sum(work.vgg_flops(512)) < 3 * fwd
    d = sum(work.discriminator_flops(64, 512))
    assert gan - hg == pytest.approx(9 * d - 2 * work.discriminator_flops(64, 512)[0])
    assert gan / 1e9 == pytest.approx(690.16, abs=0.01)


def test_trace_busy_time_and_gaps():
    ops = [(1.0, 2.0, "k2"), (1.5, 3.0, "k3"), (5.0, 6.0, "k2"), (9.0, 11.0, "k2")]
    spans = [(0.0, 4.0, "dispatch"), (2.5, 10.0, "wait"), (4.5, 4.7, "loader")]
    t = harness.Trace(ops, spans, (0.0, 10.0))
    assert t.busy_s == pytest.approx(4.0)  # [1, 3] and [5, 6] and [9, 10]
    assert t.kernel_seconds("k2") == pytest.approx(3.0)
    # gaps [0, 1] in dispatch, [3, 5] and [6, 9] in wait (opened last)
    assert dict(t.idle_by_span) == pytest.approx({"dispatch": 1.0, "wait": 5.0})
    b = t.breakdown()
    assert b["device_ops"][0][0] == "k2" and len(b["idle_gaps"]) <= 10


def test_readers_find_nothing_without_a_trace():
    run = types.SimpleNamespace(trace=None, config={"base_width": 64, "image_size": 512},
                                counts={"forward_batches": [8]}, peak_bytes=0,
                                span_n={}, span_s={})
    for name in ("k2_roofline", "k3_roofline", "device.idle_pct.infer",
                 "device.idle_pct.train", "device.idle_pct.serve",
                 "device.peak_mem_gib.train", "train.loader_wait_ms"):
        assert harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(run) is None
    run.trace = harness.Trace([], [], (0.0, 1.0))
    for name in ("k2_roofline", "k3_roofline", "device.idle_pct.infer"):
        assert harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(run) is None


def test_traffic_is_the_seeds():
    import torch

    a = dsm_tiles(3, 64, 2**31 + 3, torch.device("cpu"))
    b = dsm_tiles(3, 64, 2**31 + 3, torch.device("cpu"))
    c = dsm_tiles(3, 64, 2**31 + 4, torch.device("cpu"))
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == c[0]).all()
    imgs, masks = a
    assert imgs.dtype == masks.dtype == "uint8" and imgs.shape == (3, 64, 64, 1)
    assert set(masks.ravel().tolist()) == {0, 255} and imgs.max() == 255
    assert set(human_masks(2, 64, 9, torch.device("cpu")).ravel().tolist()) <= {0, 255}
    s, t = poisson_schedule(50.0, 20.0, 7), poisson_schedule(50.0, 20.0, 8)
    assert (s == poisson_schedule(50.0, 20.0, 7)).all() and (s.max() < 20.0)
    assert len(s) == len(t) == 1000 and (s[1:] >= s[:-1]).all()
    # another seed: the same gaps in another order
    gaps = lambda x: np.sort(np.diff(np.concatenate([[0.0], x, [20.0]])))  # noqa: E731
    assert np.allclose(gaps(s), gaps(t)) and not np.allclose(s, t)
    # a mix's set: the same tiles for every run seed, in the seed's order
    mix = {"tile_set_seed": 3}
    x, y = tile_set(mix, 6, 64, 1, torch.device("cpu")), tile_set(mix, 6, 64, 2, torch.device("cpu"))
    key = lambda t: sorted(a.tobytes() for a in t)  # noqa: E731
    assert key(x[0]) == key(y[0]) and key(x[1]) == key(y[1]) and not (x[0] == y[0]).all()
