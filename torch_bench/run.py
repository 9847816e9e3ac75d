"""Runs one cell of the benchmark once and prints its result line.

    python3 torch_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Exits non-zero without a result where the
cell's CUDA devices are not there. The limits' readings (the control,
planted faults) are torch_bench/readings.py's, the knee sweep
torch_bench/sweep.py's.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def checkout_caches() -> None:
    """Kernel and extension caches at fixed paths inside the checkout, and
    the checkout on the import path."""
    cache = ROOT / "build" / "torch_bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    args = parse(argv)
    checkout_caches()
    from torch_bench import harness

    harness.report(harness.run_cell(args, T_START))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
