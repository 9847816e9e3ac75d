"""Reads the numbers that decide ``correct`` over many seeds in one process:
the program's (the lower readings), the control's or a planted fault's
(the upper readings), from which each limit in a traffic file is set.

    python3 torch_bench/readings.py --workload gan.train-b32 --seeds 101 102 103 \\
        [--seconds 3] [--control tf32 | --fault half_batch] [--out readings.jsonl]

Each seed is a whole run of the cell (set-up, a short window, the check)
through the harness; a line per seed gives its checks and the readings
it shows beside them, and a summary per number gives the largest and
the smallest over the seeds. A fault's names are its driver's
(``break_path``/``break_step``).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from torch_bench.run import checkout_caches  # noqa: E402


def read(workload: str, seeds, seconds: float, control=None, fault=None, device=None,
         overrides=None, out=None):
    """One run a seed; returns [(seed, checks {name: value}, infos)]."""
    from torch_bench import harness

    rows = []
    for seed in seeds:
        args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=0,
                                  control=control, fault=fault)
        run = harness.execute(args, time.perf_counter(), device, overrides)
        res = run.result()
        checks = {n: v for n, v, _ in run.checks}
        row = {"workload": workload, "seed": seed, "control": control, "fault": fault,
               "correct": res["correct"], "checks": checks,
               "limits": {n: lim for n, _, lim in run.checks},
               "infos": {k: v for k, v in run.infos.items() if isinstance(v, (int, float, str))}}
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        rows.append((seed, checks, run.infos))
        del run
    return rows


def summary(rows) -> dict:
    """{number: (smallest, largest)} over the seeds; a number that is not
    finite counts as infinite."""
    names = {n for _, checks, _ in rows for n in checks}
    vals = {n: [v if math.isfinite(v) else math.inf for _, c, _ in rows
                for k, v in c.items() if k == n] for n in names}
    return {n: (min(v), max(v)) for n, v in sorted(vals.items())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    g = p.add_mutually_exclusive_group()
    g.add_argument("--control", choices=("tf32",), default=None)
    g.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    checkout_caches()
    rows = read(args.workload, args.seeds, args.seconds, args.control, args.fault, out=args.out)
    what = args.control or args.fault or "program"
    for name, (lo, hi) in summary(rows).items():
        print(f"summary {args.workload} {what} {name} n={len(rows)} min={lo:.4g} max={hi:.4g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
