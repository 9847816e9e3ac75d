"""Device time by the program's ranges in a torch.profiler trace.

``profiler_events`` reads a finished profiler: the device's operations
without user annotations, each with its correlation id; the host's CUDA
calls (the launches among them, by the same id); the program's ``tg.*``
ranges; and the benchmark's ``bench.window``. ``PhaseTrace`` is
``harness.Trace`` over those operations with the program's ranges among
the spans that label idle gaps, and each operation's device time put
down to the innermost span open when it was launched (matched by
correlation id and compared by time, not thread: ``backward()``
launches from autograd's device thread). Used by ``profile_steps.py``
and by the drivers that read a range's device time in traced runs.
"""

from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from torch_bench import harness

LAUNCH_PREFIX = "cu"  # the CUDA runtime's and driver's calls on the host: cudaLaunchKernel, ...
ANNOTATION_PREFIXES = ("bench.", "tg.")
UNATTRIBUTED = "unattributed"
OUTSIDE = "outside any span"


def innermost(marks: List[Tuple[float, float, str]], times: List[float]) -> List[str]:
    """The innermost of ``marks`` (start, end, name) open at each of
    ``times`` (sorted): the latest-started one not yet ended, as
    harness.Trace labels its gaps."""
    marks = sorted(marks)
    out, j, active = [], 0, []
    for t in times:
        while j < len(marks) and marks[j][0] <= t:
            active.append(marks[j])
            j += 1
        active = [m for m in active if m[1] > t]
        out.append(max(active)[2] if active else OUTSIDE)
    return out


class PhaseTrace(harness.Trace):
    """``harness.Trace`` over the device's operations, with the program's
    ranges among the spans that label the idle gaps, and each operation's
    device time put down to the innermost span open at its launch.

    ``device_ops``: (start, end, name, correlation id), user annotations
    already left out; ``launches``: correlation id -> host time of the
    API call that launched it; ``ranges`` and ``spans``: (start, end,
    name), the program's and the benchmark's. Times in seconds of one
    clock."""

    def __init__(self, device_ops, launches: Dict[int, float], ranges, spans,
                 window: Tuple[float, float]):
        super().__init__([(s, e, n) for s, e, n, _ in device_ops], list(spans) + list(ranges),
                         window)
        w0, w1 = window
        ops = [(launches.get(c), max(s, w0), min(e, w1), n) for s, e, n, c in device_ops
               if e > w0 and s < w1]
        found = sorted(op for op in ops if op[0] is not None)
        by_label: Dict[str, list] = defaultdict(list)
        for (_, s, e, n), label in zip(found, innermost(list(spans) + list(ranges),
                                                        [op[0] for op in found])):
            by_label[label].append((s, e, n))
        by_label[UNATTRIBUTED] = [(s, e, n) for at, s, e, n in ops if at is None]
        # a span's device time is the union of its operations: kernels it
        # launched on side streams overlap
        self.device_s_by_span = {k: sum(e - s for s, e in harness.union((s, e) for s, e, _ in v))
                                 for k, v in by_label.items()}
        self.ops_by_span: Dict[str, Dict[str, List[float]]] = {}
        for label, v in by_label.items():  # [count, seconds] by operation name
            named: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
            for s, e, n in v:
                named[n][0] += 1
                named[n][1] += e - s
            self.ops_by_span[label] = named
        self.range_n: Dict[str, int] = defaultdict(int)
        for s, e, n in ranges:
            if s >= w0 and e <= w1:
                self.range_n[n] += 1
        busy = harness.union((s, e) for _, s, e, _ in ops)
        steps = harness.union((s, e) for s, e, n in spans if n == "step")
        self.step_busy_s = overlap(busy, steps)

    def phases(self, steps: int = 1, top: int = 5) -> dict:
        """The trace's numbers by span; ``top`` operations of each span by
        device time, with their count and ms a step."""
        by = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))  # noqa: E731
        ops = {label: {n[:90]: [c / steps, 1e3 * t / steps] for n, (c, t) in
                       sorted(named.items(), key=lambda kv: -kv[1][1])[:top]}
               for label, named in self.ops_by_span.items() if named}
        return {"idle_by_span": by(self.idle_by_span),
                "device_s_by_span": by(self.device_s_by_span),
                "ops_by_span": ops, "ranges": dict(sorted(self.range_n.items()))}


def overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Total length of the intersection of two merged, sorted interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def profiler_events(prof):
    """(device operations, launches, the program's ranges, the window, the
    host's CUDA calls) of a finished profiler, in seconds of its clock:
    the operations without user annotations, as (start, end, name,
    correlation id); the calls as (start, end, name)."""
    ops, launches, ranges, window, calls = [], {}, [], None, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns() * 1e-9
        t = s + e.duration_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not (e.is_user_annotation() or name.startswith(ANNOTATION_PREFIXES)):
                ops.append((s, t, name, e.correlation_id()))
        elif name == "bench.window":
            window = (s, t)
        elif name.startswith("tg."):
            ranges.append((s, t, name))
        elif name.startswith(LAUNCH_PREFIX):  # its correlation id is the kernel's (CUPTI's)
            launches[e.correlation_id()] = s
            calls.append((s, t, name))
    return ops, launches, ranges, window, calls
