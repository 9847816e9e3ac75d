"""The port's profiler ranges and feed counters, and profile_steps.py's analysis of a trace.

On the CPU at width 8 and 64^2: the GAN and HG steps under
``torch.profiler`` give their ``tg.*`` ranges nested in order, open no
range without a profiler, and compute the same bits either way;
``BatchLoader``'s counters take exact values over an epoch whose first
batch is held back; ``PhaseTrace`` leaves user annotations out of the
device's time and puts idle gaps and device time down to the innermost
span, on synthetic events; a small HG cell runs under profile_steps.py.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from terra_gan_tpu_torch.config import Config
from terra_gan_tpu_torch.data.dataset import BatchLoader
from terra_gan_tpu_torch.training.human_guided import HumanGuidedTrainer
from terra_gan_tpu_torch.training.state import GANTrainState, adam
from terra_gan_tpu_torch.training.step import make_train_step
from terra_gan_tpu_torch.utils import trace
from terra_gan_tpu_torch.utils.weights import init_discriminator, init_generator, init_vgg

ROOT = Path(__file__).resolve().parents[1]
WIDTH, HW = 8, 64
CHILDREN = {
    "gan": ("tg.g_forward", "tg.loss", "tg.g_adv", "tg.g_backward", "tg.g_adam", "tg.d_step"),
    "hg": ("tg.g_forward", "tg.loss", "tg.g_backward", "tg.g_adam"),
}


def _batch(seed: int = 3, n: int = 2):
    rng = np.random.default_rng(seed)
    real = rng.random((n, HW, HW, 1), dtype=np.float32)
    mask = (rng.random((n, HW, HW, 1)) > 0.3).astype(np.float32)
    human = (rng.random((n, HW, HW, 1)) > 0.8).astype(np.float32)
    return {"image": torch.from_numpy(real), "mask": torch.from_numpy(mask),
            "human_mask": torch.from_numpy(human)}


def _stepper(kind: str, seed: int = 5):
    """(step() -> losses, the trained modules) of a fresh seeded model."""
    g = torch.Generator().manual_seed(seed)
    G = init_generator(WIDTH, g, "cpu")
    vgg = init_vgg(torch.Generator().manual_seed(1), "cpu")
    batch = _batch()
    if kind == "gan":
        state = GANTrainState.create(G, init_discriminator(WIDTH, g, "cpu"))
        step = make_train_step()
        return (lambda: [v for _, v in sorted(step(state, batch, vgg).items())],
                [state.generator, state.discriminator])
    step = HumanGuidedTrainer(Config()).make_step(G, adam(G.parameters(), 1e-4))
    return (lambda: [step(batch, vgg)[0]]), [G]


def _ranges(prof):
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events() if e.name().startswith("tg."))


@pytest.mark.parametrize("kind", ["gan", "hg"])
def test_step_ranges_nest_in_order(kind):
    step, _ = _stepper(kind)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    ranges = _ranges(prof)
    parent, children = ranges[0], ranges[1:]
    assert parent[2] == f"tg.{kind}_step"
    assert tuple(n for _, _, n in children) == CHILDREN[kind]
    assert all(parent[0] <= s and e <= parent[1] for s, e, _ in children)
    assert all(a[1] <= b[0] for a, b in zip(children, children[1:]))  # one after another


@pytest.mark.parametrize("kind", ["gan", "hg"])
def test_no_range_is_opened_without_a_profiler(kind, monkeypatch):
    opened = []

    def counting(name):
        opened.append(name)
        return torch._C._profiler._RecordFunctionFast(name)

    monkeypatch.setattr(trace, "_range", counting)
    step, _ = _stepper(kind)
    step()
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step()
    assert sorted(opened) == sorted((f"tg.{kind}_step",) + CHILDREN[kind])


@pytest.mark.parametrize("kind", ["gan", "hg"])
def test_a_profiled_step_computes_the_same_bits(kind):
    plain, plain_modules = _stepper(kind)
    profiled, profiled_modules = _stepper(kind)
    want = plain()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = profiled()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for a, b in zip(profiled_modules, plain_modules):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sb), kind


def test_span_is_the_null_context_off_the_profiled_thread():
    assert trace.span("tg.x") is trace.span("tg.y")  # one shared null context
    seen = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert trace.span("tg.here") is not trace.span("tg.there")
        t = threading.Thread(target=lambda: seen.update(ctx=trace.span("tg.feed")))
        t.start()
        t.join(30)
        assert not t.is_alive()
        with trace.span("tg.here"):
            pass
    assert seen["ctx"] is trace.span("tg.other")
    assert [n for _, _, n in _ranges(prof)] == ["tg.here"]


class _HeldBack:
    """Six 4x4 tiles; the first item waits for ``gate``; ``bad`` items raise."""

    def __init__(self, gate: threading.Event, bad=()):
        self.gate, self.bad = gate, set(bad)

    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i == 0:
            self.gate.wait(30)
        if i in self.bad:
            raise ValueError(f"tile {i} unreadable")
        return {"image": np.full((4, 4, 1), i, np.float32)}


def _counters():
    return BatchLoader.batches, BatchLoader.ready, BatchLoader.make_s


@pytest.mark.parametrize("bad, batches", [((), 3), ((3,), 2)])
def test_batch_loader_counters_over_one_epoch(bad, batches):
    """Batch 0 is made while the consumer waits; the feed thread then makes
    batches 1 and 2 (prefetch 2 + 1 worker: all three may be ahead) and
    exits, so both are ready when asked for. A failed batch counts in
    neither ``batches`` nor ``ready``."""
    gate = threading.Event()
    loader = BatchLoader(_HeldBack(gate, bad), 2, shuffle=False, num_workers=1, prefetch=2)
    b0, r0, m0 = _counters()
    it = iter(loader)
    threading.Timer(0.3, gate.set).start()
    first = next(it)
    for t in threading.enumerate():
        if t.name == "batch-loader":
            t.join(30)
    rest = list(it)
    b1, r1, m1 = _counters()
    assert first["image"][0, 0, 0, 0] == 0 and len(rest) == batches - 1
    assert (b1 - b0, r1 - r0) == (batches, batches - 1)
    assert m1 - m0 >= 0.2  # batch 0's decode waited on the gate


class _Slow:
    """Tiles that each take ``pause`` seconds to make."""

    def __init__(self, n: int, pause: float):
        self.n, self.pause = n, pause

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.pause)
        return {"image": np.full((2, 2, 1), i, np.float32)}


def test_batch_loader_counters_lose_nothing_under_many_feed_threads():
    """Eight feed threads publish under one lock with the interpreter
    switching threads as often as it can: every batch is counted once and
    the feed's seconds add up to at least the work put in."""
    before = _counters()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = list(BatchLoader(_Slow(64, 0.002), 1, shuffle=True, seed=4, num_workers=8))
    finally:
        sys.setswitchinterval(old)
    after = _counters()
    assert sorted(int(b["image"][0, 0, 0, 0]) for b in out) == list(range(64))
    assert after[0] - before[0] == 64 and 0 <= after[1] - before[1] <= 64
    assert after[2] - before[2] >= 64 * 0.002


# -- profile_steps.py: the analysis of a trace ------------------------------------

@pytest.fixture(scope="module")
def ps():
    spec = importlib.util.spec_from_file_location("profile_steps", ROOT / "profile_steps.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Event:
    """A kineto event as profiler_events reads it (times in ns)."""

    def __init__(self, name, start, end, device="cpu", corr=0, annotation=False):
        self._n, self._s, self._d = name, int(start * 1e9), int((end - start) * 1e9)
        self._dev = (torch.autograd.DeviceType.CUDA if device == "cuda"
                     else torch.autograd.DeviceType.CPU)
        self._c, self._u = corr, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._u


def _prof(events):
    """A finished profiler as profiler_events reads it."""
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _kernel(name, s, e, corr):
    return _Event(name, s, e, "cuda", corr)


def _launch(at, corr, api="cudaLaunchKernel"):
    return _Event(api, at, at + 1e-6, "cpu", corr)


# A window of 10 s: the benchmark's step span 0.9-9.1 holding tg.hg_step
# 1-9, tg.g_forward 1.1-3 and tg.g_backward 4-8; kernels launched in
# g_forward (by the step's thread) and in g_backward (by autograd's device
# thread: only the time says where).
WINDOW = [_Event("bench.window", 0.0, 10.0, annotation=True)]
RANGES = [_Event("tg.hg_step", 1.0, 9.0), _Event("tg.g_forward", 1.1, 3.0),
          _Event("tg.g_backward", 4.0, 8.0)]
KERNELS = [_kernel("conv_fwd", 1.5, 2.5, 11), _launch(1.2, 11),
           _kernel("conv_dgrad", 5.0, 6.0, 12), _launch(4.5, 12, "cuLaunchKernel"),
           _kernel("memcpy", 6.5, 7.0, 13)]  # 13: no launch seen
ANNOTATIONS = [_Event("bench.window", 1.5, 7.0, "cuda", annotation=True),
               _Event("Optimizer.step#Adam.step", 5.0, 8.5, "cuda", annotation=True),
               _Event("tg.loss", 2.6, 6.9, "cuda"),  # by its name alone
               _Event("aten::mm", 1.3, 1.4, "cpu", corr=11)]  # a torch op's own id
SPANS = [(0.9, 9.1, "step")]


def _phase_trace(ps, events):
    ops, launches, ranges, window, _ = ps.profiler_events(_prof(events))
    return ps.PhaseTrace(ops, launches, ranges, SPANS, window)


def test_annotations_on_the_device_leave_busy_and_idle_unchanged(ps):
    from torch_bench import harness

    bare = _phase_trace(ps, WINDOW + RANGES + KERNELS)
    annotated = _phase_trace(ps, WINDOW + RANGES + KERNELS + ANNOTATIONS)
    plain = harness.Trace([(1.5, 2.5, "conv_fwd"), (5.0, 6.0, "conv_dgrad"),
                           (6.5, 7.0, "memcpy")], SPANS, (0.0, 10.0))
    for tr in (bare, annotated):
        assert tr.busy_s == pytest.approx(plain.busy_s) == pytest.approx(2.5)
        assert dict(tr.by_name) == pytest.approx(dict(plain.by_name))
        assert tr.device_events == 3
        assert sum(tr.idle_by_span.values()) == pytest.approx(7.5)


def test_idle_gaps_go_to_the_innermost_program_range(ps):
    tr = _phase_trace(ps, WINDOW + RANGES + KERNELS)
    # each gap goes whole to the innermost span open where it begins: 0-1.5
    # outside, 2.5-5 in g_forward, 6-6.5 and 7-10 in g_backward
    assert dict(tr.idle_by_span) == pytest.approx(
        {"outside any span": 1.5, "tg.g_forward": 2.5, "tg.g_backward": 3.5})
    assert tr.range_n == {"tg.hg_step": 1, "tg.g_forward": 1, "tg.g_backward": 1}


def test_device_time_goes_to_the_range_open_at_launch_on_any_thread(ps):
    tr = _phase_trace(ps, WINDOW + RANGES + KERNELS + ANNOTATIONS)
    assert dict(tr.device_s_by_span) == pytest.approx(
        {"tg.g_forward": 1.0, "tg.g_backward": 1.0, "unattributed": 0.5})
    assert tr.step_busy_s == pytest.approx(2.5)
    assert tr.phases(steps=2)["ops_by_span"]["tg.g_backward"] == {"conv_dgrad": [0.5, 500.0]}


def test_a_range_on_two_streams_counts_its_device_time_once(ps):
    events = WINDOW + RANGES + [_kernel("fft_a", 1.5, 2.5, 31), _launch(1.2, 31),
                                _kernel("fft_b", 2.0, 2.8, 32), _launch(1.3, 32)]
    tr = _phase_trace(ps, events)
    assert tr.device_s_by_span["tg.g_forward"] == pytest.approx(1.3)
    assert tr.by_name == pytest.approx({"fft_a": 1.0, "fft_b": 0.8})


def test_unmatched_operations_are_unattributed_and_launches_outside_ranges_take_the_span(ps):
    events = WINDOW + [_kernel("copy_h2d", 0.2, 0.4, 21), _launch(0.1, 21),
                       _kernel("k", 1.2, 1.3, 22), _launch(1.05, 22),
                       _kernel("orphan", 2.0, 2.25, 23)]
    ops, launches, ranges, window, _ = ps.profiler_events(_prof(events))
    tr = ps.PhaseTrace(ops, launches, ranges, [(1.0, 9.0, "step")], window)
    assert dict(tr.device_s_by_span) == pytest.approx(
        {"outside any span": 0.2, "step": 0.1, "unattributed": 0.25})


def test_host_calls_a_step_and_where_the_blocking_ones_were_made(ps):
    events = WINDOW + RANGES + KERNELS + [
        _Event("cudaFree", 4.2, 4.4), _Event("cudaFree", 8.5, 8.6),
        _Event("cudaMalloc", 11.0, 12.0)]  # after the window
    _, _, ranges, window, calls = ps.profiler_events(_prof(events))
    got = ps.host_calls(calls, SPANS + ranges, window, 2)
    assert got["per_step"]["cudaFree"] == pytest.approx([1.0, 150.0])
    assert set(got["per_step"]) == {"cudaFree", "cudaLaunchKernel", "cuLaunchKernel"}
    assert got["blocking_by_span"] == {"cudaFree": {"tg.g_backward": 1, "tg.hg_step": 1}}


def test_per_step_numbers_from_the_counters(ps):
    tr = _phase_trace(ps, WINDOW + RANGES + KERNELS)
    got = ps.per_step({"steps": 4, "feed_batches": 4, "feed_ready": 3, "feed_make_s": 0.2,
                       "segments_allocated": 6, "segments_freed": 2}, tr)
    assert got == pytest.approx({"loss_device_ms": 0.0, "d_device_ms": 0.0, "alloc_calls": 2.0,
                                 "ready_pct": 75.0, "make_ms": 50.0})


def test_per_step_k2_train_counts(ps):
    tr = _phase_trace(ps, WINDOW + RANGES + KERNELS)
    got = ps.per_step({"steps": 4, "feed_batches": 0, "k2_train_stages": 56,
                       "k2_train.mma_c1": 4, "k2_train.mma": 28, "k2_train.mma_split": 24,
                       "k2_train.split_reduce": 24, "k2_train.simt": 0}, tr)
    assert got["k2_train_stages"] == 14.0
    assert got["k2_train_launches"] == {"mma_c1": 1.0, "mma": 7.0, "mma_split": 6.0,
                                        "split_reduce": 6.0, "simt": 0.0}


def test_per_step_ffc_local_launches(ps):
    tr = _phase_trace(ps, WINDOW + RANGES + KERNELS)
    got = ps.per_step({"steps": 4, "feed_batches": 0, "ffc_local_launches": 144}, tr)
    assert got["ffc_local_launches"] == 36.0  # Big-LaMa's 36 block FFCs a forward, a launch each
    assert "ffc_local_launches" not in ps.per_step({"steps": 4, "feed_batches": 0}, tr)


@pytest.mark.parametrize("counter", ["ffc_local_dgrad_launches", "ffc_local_wgrad_launches"])
def test_per_step_ffc_local_backward_launches(ps, counter):
    tr = _phase_trace(ps, WINDOW + RANGES + KERNELS)
    got = ps.per_step({"steps": 4, "feed_batches": 0, counter: 144}, tr)
    assert got[counter] == 36.0  # one dgrad and one wgrad call a block FFC a step
    assert counter not in ps.per_step({"steps": 4, "feed_batches": 0}, tr)


def test_per_step_contextual_attention_counts(ps):
    tr = _phase_trace(ps, WINDOW + RANGES + KERNELS)
    got = ps.per_step({"steps": 4, "feed_batches": 0, "ctx_attn_calls": 4,
                       "ctx_attn_scores": 4 * 16 * 4096 * 4096}, tr)
    assert got["ctx_attn_calls"] == 1.0  # DeepFill's one attention a forward
    assert got["ctx_attn_scores"] == 16 * 4096 * 4096  # B L_q L_k at batch 16, 512^2
    assert got["deepfill_forward_ms"] == {"tg.df_coarse": 0.0, "tg.ctx_attn": 0.0,
                                          "tg.df_refine": 0.0, "tg.g_forward": 250.0}
    assert ps.DEEPFILL_RANGES == ("tg.df_coarse", "tg.ctx_attn", "tg.df_refine", "tg.g_forward")
    for key in ("ctx_attn_calls", "ctx_attn_scores", "deepfill_forward_ms"):
        assert key not in ps.per_step({"steps": 4, "feed_batches": 0}, tr)


def test_a_small_hg_cell_under_profile_steps(ps):
    args = argparse.Namespace(workload="gan.hg-b5", seed=2**31 + 5, seconds=1.0, trace=0)
    small = {"config": {"base_width": 8, "discriminator_width": 8, "image_size": 128,
                        "batch_size": {"gan": 4, "hg": 4}}, "traffic": {"tiles": 12}}
    rep = ps.profile_cell(args, time.perf_counter(), torch.device("cpu"), small)
    steps = rep["counts"]["steps"]
    assert rep["correct"] and steps >= 3
    assert rep["ranges"]["tg.hg_step"] == steps
    assert all(rep["ranges"][n] == steps for n in CHILDREN["hg"])
    assert rep["counts"]["feed_batches"] == steps
    assert 0 <= rep["counts"]["feed_ready"] <= steps
    assert rep["per_step"]["k2_train_stages"] == 0  # the plain version on the CPU: no launch
    assert rep["busy_s"] == 0 and rep["idle_by_span"]  # no device here: all idle, labelled
