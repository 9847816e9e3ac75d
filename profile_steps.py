"""Where the device's time and idle go inside the training steps, by the port's ``tg.*`` ranges.

    python3 profile_steps.py --workload gan.hg-b5 --seed 7 [--seconds 51] [--out FILE]

Runs one training cell of BENCHMARK.json (``gan.train-b32``,
``gan.hg-b5`` or ``lama.train-b16``) as ``torch_bench/run.py`` does, with its own
``torch.profiler`` session over the window (the harness's tracing stays
off), and prints one JSON object: the cell's end-to-end metrics and
``correct``, then

  * ``busy_s``, ``window_s``, ``idle_pct``: the device's operations
    alone, with every user annotation left out (the benchmark's
    ``bench.*`` and any ``record_function`` range's copy on the device's
    timeline);
  * ``idle_by_span``: the idle gaps, each put down to the innermost span
    open when it began, of the benchmark's own (``loader``, ``upload``,
    ``step``) and the program's ``tg.*`` ranges;
  * ``device_s_by_span``: each operation put down to the innermost span
    open when it was launched, matched to its launch on the host by
    correlation id and compared by time, not thread (``backward()``
    launches from autograd's device thread while the step's thread waits
    in ``tg.g_backward``), and a span's device time the union of its
    operations; ``unattributed``, where no launch matched;
    ``ops_by_span``, each span's top operations, count and ms a step;
  * ``per_step``: ``loss_device_ms`` and ``d_device_ms`` (the device time
    launched in ``tg.loss`` and ``tg.d_step`` over the window's steps;
    the loss stack's backward, VGG's included, is launched in
    ``tg.g_backward``), ``alloc_calls`` (the caching allocator's
    cudaMalloc and cudaFree calls: segments allocated plus freed), the
    feed's ``ready_pct`` and ``make_ms`` from ``BatchLoader``'s counters,
    and ``k2_train_stages`` and ``k2_train_launches`` (by variant), the
    generator's PConv stages run on K2's train variant
    (``fused_pconv_train.launches`` and ``.variants``): 14 a forward;
    ``ffc_local_launches``, Big-LaMa's block FFCs run on their kernel
    (``ffc_local.launches``, one launch an FFC): 36 a forward;
    ``ffc_local_dgrad_launches`` and ``ffc_local_wgrad_launches``, their
    backward's two kernels (``ffc_local_dgrad.launches`` and
    ``ffc_local_wgrad.launches``, one call an FFC each): 36 a step;
    with Big-LaMa as G, ``spectral_calls`` and ``spectral_elements``
    (``SpectralTransform.calls`` and ``.elements``: 36 transforms a
    forward), ``lama_forward_ms``, the device ms a step launched in
    each of the generator's ranges (``tg.lama_down``, ``tg.ffc_local``,
    ``tg.ffc_spectral``, ``tg.lama_up``, and ``tg.g_forward`` itself for
    the rest: the blocks' BatchNorm, ReLU and residual sums), and
    ``lama_backward_ms``, the same of ``tg.ffc_local_bwd`` (the block
    FFCs' backward, opened on autograd's device thread) and of
    ``tg.g_backward`` itself for the rest of the step's backward;
  * ``host_calls``: the host's CUDA runtime and driver calls a step, count
    and ms by name, and the span each blocking one (malloc, free,
    synchronise, copy) was made in;
  * ``counts``: the counters' differences over the window.

The analysis (``PhaseTrace``, ``profiler_events``) is
``torch_bench/phases.py``'s, which the harness would need to read these
as per-layer metrics of traced runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
from collections import defaultdict  # noqa: E402
from typing import Dict, Optional, Tuple  # noqa: E402

import torch  # noqa: E402

from torch_bench import harness  # noqa: E402
from torch_bench.phases import (  # noqa: E402
    UNATTRIBUTED,
    PhaseTrace,
    innermost,
    profiler_events,
)
from torch_bench.run import checkout_caches  # noqa: E402

# the device's time in Big-LaMa's forward, by range (models/lama.py)
LAMA_RANGES = ("tg.lama_down", "tg.ffc_local", "tg.ffc_spectral", "tg.lama_up", "tg.g_forward")
# and in the step's backward (ops/cuda/ffc_kernel.py's FFCLocal.backward)
LAMA_BWD_RANGES = ("tg.ffc_local_bwd", "tg.g_backward")
# calls that can hold the host until the device drains
BLOCKING = ("cudaMalloc", "cudaFree", "cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")


def host_calls(calls, marks, window: Tuple[float, float], steps: int) -> dict:
    """The host's CUDA calls in the window, a step: count and ms by name
    (the 8 that took longest), and where the blocking ones were made."""
    w0, w1 = window
    calls = sorted(c for c in calls if w0 <= c[0] < w1)
    n: Dict[str, int] = defaultdict(int)
    sec: Dict[str, float] = defaultdict(float)
    for s, e, name in calls:
        n[name] += 1
        sec[name] += e - s
    top = sorted(sec, key=lambda k: -sec[k])[:8]
    blocking = [c for c in calls if c[2] in BLOCKING]
    where: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for (_, _, name), label in zip(blocking, innermost(marks, [c[0] for c in blocking])):
        where[name][label] += 1
    return {"per_step": {k: [n[k] / steps, 1e3 * sec[k] / steps] for k in top},
            "blocking_by_span": {k: dict(v) for k, v in where.items()}}


def counters(device: torch.device) -> Dict[str, float]:
    from terra_gan_tpu_torch.data.dataset import BatchLoader
    from terra_gan_tpu_torch.models.lama import SpectralTransform
    from terra_gan_tpu_torch.ops.cuda.ffc_kernel import ffc_local, ffc_local_dgrad, ffc_local_wgrad
    from terra_gan_tpu_torch.ops.cuda.pconv_kernel import fused_pconv_train

    out = {"feed_batches": BatchLoader.batches, "feed_ready": BatchLoader.ready,
           "feed_make_s": BatchLoader.make_s, "k2_train_stages": fused_pconv_train.launches,
           **{f"k2_train.{v}": n for v, n in fused_pconv_train.variants.items()},
           "ffc_local_launches": ffc_local.launches,
           "ffc_local_dgrad_launches": ffc_local_dgrad.launches,
           "ffc_local_wgrad_launches": ffc_local_wgrad.launches,
           "spectral_calls": SpectralTransform.calls,
           "spectral_elements": SpectralTransform.elements}
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        out.update(segments_allocated=stats.get("segment.all.allocated", 0),
                   segments_freed=stats.get("segment.all.freed", 0),
                   alloc_retries=stats.get("num_alloc_retries", 0))
    return out


class PhaseRun(harness.Run):
    """A run whose window this module profiles, keeping every host span."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.tracing = False  # the harness's own profiler stays off
        self.phase_trace: Optional[PhaseTrace] = None
        self.calls: tuple = ()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        yield
        t1 = time.perf_counter()
        self.span_s[name] += t1 - t0
        self.span_n[name] += 1
        self.span_log.append((t0, t1, name))

    @contextlib.contextmanager
    def window(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with super().window() as t0:
                before = counters(self.device)
                yield t0
                after = counters(self.device)
        self.counts.update({k: after[k] - before[k] for k in before})
        ops, launches, ranges, window, calls = profiler_events(prof)
        w0 = window[0]  # the profiler's clock at t0
        spans = [(s - t0 + w0, e - t0 + w0, n) for s, e, n in self.span_log]
        window = (w0, w0 + self.window_s)
        self.phase_trace = PhaseTrace(ops, launches, ranges, spans, window)
        self.calls = (calls, spans + ranges, window)  # read once the driver has counted steps


def per_step(counts: dict, trace: PhaseTrace) -> dict:
    steps = counts["steps"]
    out = {"loss_device_ms": 1e3 * trace.device_s_by_span.get("tg.loss", 0.0) / steps,
           "d_device_ms": 1e3 * trace.device_s_by_span.get("tg.d_step", 0.0) / steps}
    if "segments_allocated" in counts:
        out["alloc_calls"] = (counts["segments_allocated"] + counts["segments_freed"]) / steps
    if counts["feed_batches"]:
        out["ready_pct"] = 100.0 * counts["feed_ready"] / counts["feed_batches"]
        out["make_ms"] = 1e3 * counts["feed_make_s"] / counts["feed_batches"]
    if "k2_train_stages" in counts:
        out["k2_train_stages"] = counts["k2_train_stages"] / steps
        out["k2_train_launches"] = {k.split(".", 1)[1]: n / steps for k, n in counts.items()
                                    if k.startswith("k2_train.")}
    for k in ("ffc_local_launches", "ffc_local_dgrad_launches", "ffc_local_wgrad_launches"):
        if k in counts:
            out[k] = counts[k] / steps
    if counts.get("spectral_calls"):
        out["spectral_calls"] = counts["spectral_calls"] / steps
        out["spectral_elements"] = counts["spectral_elements"] / steps
        out["lama_forward_ms"] = {k: 1e3 * trace.device_s_by_span.get(k, 0.0) / steps
                                  for k in LAMA_RANGES}
        out["lama_backward_ms"] = {k: 1e3 * trace.device_s_by_span.get(k, 0.0) / steps
                                   for k in LAMA_BWD_RANGES}
    return out


def report(run: PhaseRun) -> dict:
    res = run.result()
    tr = run.phase_trace
    in_step = sum(v for k, v in tr.device_s_by_span.items() if k.startswith("tg."))
    return {"workload": run.cell["name"], "seed": run.seed, "correct": res["correct"],
            "device": res["device"]["kind"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "window_s": tr.window_s, "busy_s": tr.busy_s,
            "idle_pct": 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.window_s else None,
            "step_busy_s": tr.step_busy_s, "tg_device_s": in_step,
            "unattributed_pct_of_busy": (100.0 * tr.device_s_by_span[UNATTRIBUTED] / tr.busy_s
                                         if tr.busy_s else None),
            "per_step": per_step(run.counts, tr), **tr.phases(run.counts["steps"]),
            "host_calls": host_calls(*run.calls, run.counts["steps"]),
            "counts": run.counts, "checks": res["checks"]}


def profile_cell(args, t_start: float, device: Optional[torch.device] = None,
                 overrides: Optional[dict] = None) -> dict:
    """Runs ``args.workload`` once under this module's profiler and returns
    the report. Without ``device`` the cell's CUDA device has to be there;
    a test passes the CPU and ``overrides`` of the sizes, as
    harness.execute takes them."""
    bench = harness.load_json("BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit(f"{args.workload} needs a CUDA device")
        device = torch.device("cuda", 0)
    run = PhaseRun(args, bench, cell, t_start, device, overrides)
    if device.type == "cuda":  # the configuration's precision, as harness.execute sets it
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = bool(
            run.config.get("tf32", False))
    importlib.import_module(f"torch_bench.drivers.{run.traffic['driver']}").run(run)
    return report(run)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--out", default=None, help="append the JSON line to this file too")
    args = p.parse_args(argv)
    checkout_caches()
    args.seconds = args.seconds or harness.load_json("BENCHMARK.json")["run_seconds"]
    args.trace = 0
    line = json.dumps(profile_cell(args, T_START))
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
