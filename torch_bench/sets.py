"""Runs cells of the benchmark several times, one process a run, and prints
each run's line and, per metric, the median and the spread (quartile
distance over the median, as ``statistics.quantiles(n=4)`` gives them).

    python3 torch_bench/sets.py --workload infer.grid-c8 --seeds 11 12 13 \\
        [--seconds 20] [--trace 0] [--out runs.jsonl]

Several ``--workload`` run in turn for each seed. Without ``--seconds``
a run lasts BENCHMARK.json's ``run_seconds``. Beside each run's line go
the state of the card and of the host, sampled every few seconds while
it runs: the card's SM clock, temperature, power and active throttle
reasons, and the time of a fixed pure-Python loop (the host core's
speed); and the CPU seconds the run took. They tell a slower card from
a slower or busier host.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


CARD_STATE = "clocks.sm,clocks.mem,temperature.gpu,power.draw,clocks_throttle_reasons.active"


def card_state() -> str:
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={CARD_STATE}",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def host_probe_ms() -> float:
    """Milliseconds of a fixed pure-Python loop: the host core's speed now."""
    t0 = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i & 7
    return (time.perf_counter() - t0) * 1e3


def correlation(a, b) -> float:
    try:
        return statistics.correlation(a, b)
    except statistics.StatisticsError:  # a constant column
        return float("nan")


class Sampler:
    """Samples the card's state and the host probe every ``every`` seconds
    on a thread of its own while a run goes on."""

    def __init__(self, every: float = 5.0):
        self.every, self.cards, self.probes = every, [], []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self) -> None:
        while not self._stop.wait(self.every):
            self.cards.append(card_state())
            self.probes.append(host_probe_ms())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()

    def summary(self) -> dict:
        fields = [c.split(", ") for c in self.cards if c.count(",") == 4]
        num = lambda i: [float(f[i].split()[0]) for f in fields]  # noqa: E731
        return {"probe_ms": statistics.median(self.probes) if self.probes else float("nan"),
                "probe_ms_max": max(self.probes, default=float("nan")),
                "sm_mhz_min": min(num(0), default=float("nan")),
                "temp_c_max": max(num(2), default=float("nan")),
                "power_w_max": max(num(3), default=float("nan")),
                "throttle": sorted({f[4] for f in fields})}


def spread(values) -> float:
    if len(values) < 2:
        return float("nan")
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else float("nan")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--timeout", type=float, default=1200)
    args = p.parse_args(argv)
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    print(f"card: {card()}", flush=True)
    rows = []
    for seed in args.seeds:
        for wl in args.workload:
            cmd = [sys.executable, "torch_bench/run.py", "--workload", wl, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(args.trace)]
            cpu0 = resource.getrusage(resource.RUSAGE_CHILDREN)
            t0 = time.perf_counter()
            with Sampler() as sampler:
                try:
                    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                                          timeout=args.timeout)
                    rc, out, err = proc.returncode, proc.stdout, proc.stderr
                except subprocess.TimeoutExpired as e:
                    rc, out, err = 124, e.stdout or "", e.stderr or ""
                    out = out.decode() if isinstance(out, bytes) else out
                    err = err.decode() if isinstance(err, bytes) else err
            wall = time.perf_counter() - t0
            cpu1 = resource.getrusage(resource.RUSAGE_CHILDREN)
            host = {**sampler.summary(), "cpu_s": (cpu1.ru_utime - cpu0.ru_utime)
                    + (cpu1.ru_stime - cpu0.ru_stime), "loadavg": os.getloadavg()[0]}
            lines = out.strip().splitlines()
            try:
                res = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                res = None
            row = {"workload": wl, "seed": seed, "rc": rc, "wall_s": wall, "result": res,
                   "host": host,
                   "info": [ln[5:] for ln in err.splitlines() if ln.startswith("info ")]}
            if res is None or rc != 0:
                row["stderr_tail"] = err[-3000:]
            rows.append(row)
            print(json.dumps(row), flush=True)
            if args.out:
                with open(ROOT / args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    for wl in args.workload:
        mine = [r["result"] for r in rows if r["workload"] == wl and r["result"]]
        names = sorted({m for r in mine for m in r["metrics"]})
        for m in names:
            vals = [r["metrics"][m]["value"] for r in mine if m in r["metrics"]]
            print(f"summary {wl} {m} n={len(vals)} median={statistics.median(vals):.6g} "
                  f"spread={spread(vals):.4%} min={min(vals):.6g} max={max(vals):.6g}")
        runs = [r for r in rows if r["workload"] == wl and r["result"]]
        for m in names:  # does the metric follow the host?
            pts = [(r["result"]["metrics"][m]["value"], r["result"]["metrics"]["setup_s"]["value"],
                    r["host"]["probe_ms"], r["host"]["cpu_s"]) for r in runs
                   if m != "setup_s" and {m, "setup_s"} <= set(r["result"]["metrics"])]
            if len(pts) >= 3:
                cols = list(zip(*pts))
                rs = " ".join(f"r({k})={correlation(cols[0], c):.3f}" for k, c in
                              zip(("setup_s", "probe_ms", "cpu_s"), cols[1:]))
                print(f"summary {wl} {m} {rs}")
        for c in sorted({c for r in mine for c in r["checks"]}):
            vals = [r["checks"][c]["value"] for r in mine if c in r["checks"]]
            print(f"summary {wl} check {c} max={max(vals):.4g} min={min(vals):.4g} "
                  f"values={[float(f'{v:.3g}') for v in vals]}")
        print(f"summary {wl} correct {sum(r['correct'] for r in mine)}/{len(mine)} "
              f"of {sum(r['workload'] == wl for r in rows)} runs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
