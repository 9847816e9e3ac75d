"""One run of one cell: set-up, the measured window, the check, the result line.

The cell's files are found by name: ``configs/<config>.json``,
``traffic/<mix>.json`` (its ``driver`` names ``drivers/<driver>.py``), and
one reader per metric, ``metrics/<metric>.py``, whose ``read(run)``
returns the number or None where it finds nothing to read. A run prints
the numbers it compared, each with its limit, as the last lines of
standard error, and as its last line of standard output one JSON object:
correct, attempted, failed, metrics, device, breakdown (traced runs) and
checks.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"torch_bench_{path.stem}".replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def union(intervals) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Trace:
    """What the profiler saw in the window: device operations by name, the
    device's busy time, and its idle gaps labelled by the benchmark's host
    span open when each began. Times in seconds."""

    def __init__(self, device_ops: List[Tuple[float, float, str]],
                 spans: List[Tuple[float, float, str]], window: Tuple[float, float]):
        w0, w1 = window
        ops = [(max(s, w0), min(e, w1), n) for s, e, n in device_ops if e > w0 and s < w1]
        self.window_s = w1 - w0
        self.device_events = len(ops)
        self.by_name: Dict[str, float] = defaultdict(float)
        for s, e, n in ops:
            self.by_name[n] += e - s
        busy = union((s, e) for s, e, _ in ops)
        self.busy_s = sum(e - s for s, e in busy)
        gaps, at = [], w0
        for s, e in busy + [(w1, w1)]:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        spans = sorted(spans)
        self.idle_by_span: Dict[str, float] = defaultdict(float)
        j, active = 0, []
        for g0, g1 in gaps:  # both in time order: a sweep
            while j < len(spans) and spans[j][0] <= g0:
                active.append(spans[j])
                j += 1
            active = [sp for sp in active if sp[1] > g0]
            label = max(active)[2] if active else "outside any span"
            self.idle_by_span[label] += g1 - g0

    def kernel_seconds(self, *parts: str) -> float:
        """Device time of the operations whose name holds any of ``parts``."""
        return sum(t for n, t in self.by_name.items() if any(p in n for p in parts))

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], t] for n, t in top],
                "idle_gaps": [[n, t] for n, t in gaps]}


def _kineto_events(prof):
    """(device operations, the window's range) from a finished profiler, in
    s of its clock."""
    ops, window = [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns() * 1e-9
        t = s + e.duration_ns() * 1e-9
        if name == "bench.window" and e.device_type() == torch.autograd.DeviceType.CPU:
            window = (s, t)
        elif e.device_type() == torch.autograd.DeviceType.CUDA and not name.startswith("bench."):
            ops.append((s, t, name))
    return ops, window


class Run:
    """One run's state, shared by the driver, the readers and the result."""

    def __init__(self, args, bench: dict, cell: dict, t_start: float, device: torch.device,
                 overrides: Optional[dict] = None):
        self.args, self.bench, self.cell = args, bench, cell
        self.seed, self.seconds, self.tracing = args.seed, args.seconds, bool(args.trace)
        self.control = getattr(args, "control", None)
        self.fault = getattr(args, "fault", None)
        self.t_start, self.device = t_start, device
        cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
        self.config = load_json(cfg["file"])
        self.traffic = load_json(f"torch_bench/traffic/{cell['traffic']}.json")
        for key, values in (overrides or {}).items():  # a test's smaller sizes
            getattr(self, key).update(values)
        self.counts: Dict[str, object] = {}
        self.span_s: Dict[str, float] = defaultdict(float)
        self.span_n: Dict[str, int] = defaultdict(int)
        self.span_log: List[Tuple[float, float, str]] = []
        self.setup_s = self.window_s = None
        self.peak_bytes = 0
        self.trace: Optional[Trace] = None
        self.attempted = self.failed = 0
        self.checks: List[Tuple[str, float, float]] = []
        self.infos: Dict[str, object] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        """Host-clock time under ``name``, from any thread; kept as an
        interval when tracing, to label the device's idle gaps."""
        t0 = time.perf_counter()
        yield
        t1 = time.perf_counter()
        self.span_s[name] += t1 - t0
        self.span_n[name] += 1
        if self.tracing:
            self.span_log.append((t0, t1, name))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self):
        """The measured window. Set-up is everything before it."""
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        prof = None
        if self.tracing:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_start
        try:
            with torch.profiler.record_function("bench.window"):
                yield t0
                self.sync()
        finally:
            self.window_s = time.perf_counter() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
        if prof is not None:
            ops, window = _kineto_events(prof)
            w0 = window[0] if window else 0.0  # the profiler's clock at t0
            spans = [(s - t0 + w0, e - t0 + w0, n) for s, e, n in self.span_log]
            self.trace = Trace(ops, spans, (w0, w0 + self.window_s))

    def free(self) -> None:
        """Release the program's memory before the reference runs."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    def info(self, name: str, value) -> None:
        """A reading shown on standard error beside the checks, not compared."""
        self.infos[name] = value
        text = f"{value:.6g}" if isinstance(value, (int, float)) else str(value)
        print(f"info {name} {text}", file=sys.stderr)

    @property
    def limits(self) -> Dict[str, float]:
        return self.traffic["limits"]

    # -- result -------------------------------------------------------------
    def metric_defs(self) -> List[dict]:
        kind = "per_layer" if self.tracing else "end_to_end"
        name = self.cell["name"]
        return [m for m in self.bench[kind] if name in m.get("workloads", [name])]

    def result(self) -> dict:
        metrics = {}
        for m in self.metric_defs():
            reader = load_module(HERE / "metrics" / f"{m['name']}.py")
            value = reader.read(self)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        correct = bool(self.checks) and self.attempted > 0 and self.failed == 0 and all(
            v <= lim for _, v, lim in self.checks)  # NaN fails
        dev = {"platform": "gpu" if self.device.type == "cuda" else self.device.type,
               "kind": (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                        else "cpu"),
               "count": self.cell["chips"] if self.device.type == "cuda" else 1,
               "memory_peak_bytes": self.peak_bytes}
        out = {"correct": correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": metrics, "device": dev}
        if self.trace is not None:
            dev["busy_s"], dev["window_s"] = self.trace.busy_s, self.trace.window_s
            out["breakdown"] = self.trace.breakdown()
        out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in self.checks}
        return out


def execute(args, t_start: float, device: Optional[torch.device] = None,
            overrides: Optional[dict] = None) -> Run:
    """Runs ``args.workload`` once and returns the finished ``Run``.
    Without ``device`` the cell's chips have to be there (the benchmark's
    runs); a test passes the CPU and ``overrides`` of the config's and the
    mix's sizes. ``args.control`` and ``args.fault``, where present, put
    the control in the program's place or break the timed path
    (torch_bench/readings.py)."""
    bench = load_json("BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        raise SystemExit(f"no workload {args.workload!r} in BENCHMARK.json")
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            raise SystemExit(3)
        device = torch.device("cuda", 0)
    run = Run(args, bench, cell, t_start, device, overrides)
    if device.type == "cuda":
        # the configuration's precision: fp32 products, TF32 off
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = bool(
            run.config.get("tf32", False))
    importlib.import_module(f"torch_bench.drivers.{run.traffic['driver']}").run(run)
    return run


def run_cell(args, t_start: float, device: Optional[torch.device] = None,
             overrides: Optional[dict] = None) -> dict:
    """Runs ``args.workload`` once and returns its result line's object."""
    return execute(args, t_start, device, overrides).result()


def report(result: dict) -> None:
    """The compared numbers on standard error, then the result line."""
    print(f"correct {result['correct']} attempted {result['attempted']} "
          f"failed {result['failed']}", file=sys.stderr)
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']:.6g} limit {c['limit']:.6g} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
