"""The knee sweep of a serving cell: the cell run once at each offered rate,
a process a rate as the benchmark's runs are, with nothing of its
traffic mix changed but the rate.

    python3 torch_bench/sweep.py --workload infer.serve-open --seed 601 \\
        --seconds 20 --rates 50 60 70 80 90 100 120 140 [--out sweep.jsonl]

The cell has to be in BENCHMARK.json.

A line per rate: the offered and completed requests/s, the p50 and p95
latency as the cell's readers take them, the failed requests, the
latency's slope over the window (ms per s: a backlog that grows) and
the generator's lateness. The cell's rate is set from these by hand
(PERF.md says how) and written into its traffic file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from torch_bench.run import checkout_caches  # noqa: E402

KEYS = ("offered_per_s", "completed_per_s", "failed", "latency_slope_ms_per_s",
        "lateness_ms_p95")


def sweep(workload: str, rates, seed: int, seconds: float, device=None, overrides=None,
          out=None):
    """One run a rate; returns a row a rate."""
    from torch_bench import harness

    readers = {m: harness.load_module(harness.HERE / "metrics" / f"{f}.py")
               for m, f in (("p50_ms", "serve.p50_ms"), ("p95_ms", "serve_p95_ms"))}
    rows = []
    for rate in rates:
        mix = dict((overrides or {}).get("traffic", {}), rate=rate)
        args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=0)
        run = harness.execute(args, time.perf_counter(), device,
                              {**(overrides or {}), "traffic": mix})
        row = {"rate": rate, **{k: r.read(run) for k, r in readers.items()},
               **{k: run.infos[f"loadgen.{k}"] for k in KEYS},
               "correct": run.result()["correct"]}
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        rows.append(row)
        del run
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if len(args.rates) == 1:
        checkout_caches()
        sweep(args.workload, args.rates, args.seed, args.seconds, out=args.out)
        return 0
    for rate in args.rates:  # a fresh process a rate
        cmd = [sys.executable, __file__, "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--rates", str(rate)]
        out = subprocess.run(cmd + (["--out", args.out] if args.out else []),
                             capture_output=True, text=True)
        rows = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        print(rows[-1] if rows else json.dumps({"rate": rate, "rc": out.returncode,
                                                "stderr_tail": out.stderr[-2000:]}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
