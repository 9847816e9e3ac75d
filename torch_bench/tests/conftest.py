"""The benchmark's CPU tests: ``python -m pytest torch_bench/tests -q`` from the
root of the repo. They run cells at small sizes on the CPU, where the
program's kernels run their plain versions."""

import argparse
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small sizes a cell runs at here: every stage halves evenly down to 1x1
SMALL = {
    "infer.grid-c8": {"config": {"base_width": 8, "image_size": 128},
                      "traffic": {"tiles": 20, "sample_share": 0.5}},
    "infer.serve-open": {"config": {"base_width": 8, "image_size": 128},
                         "traffic": {"payloads": 8, "rate": 10, "out_size": 100,
                                     "sample_share": 0.5}},
    "gan.train-b32": {"config": {"base_width": 8, "discriminator_width": 8, "image_size": 128,
                                 "batch_size": {"gan": 4, "hg": 4}},
                      "traffic": {"tiles": 15}},
    "gan.hg-b5": {"config": {"base_width": 8, "discriminator_width": 8, "image_size": 128,
                             "batch_size": {"gan": 4, "hg": 4}},
                  "traffic": {"tiles": 12}},
}


# out of BENCHMARK.json (its p95 follows the shared host's speed, PERF.md);
# its driver, load generator and check stay, tested here, for the cell to
# come back as data
SERVING_CELL = {"name": "infer.serve-open", "config": "pconvunet512-infer-fp32",
                "traffic": "serve-open", "chips": 1,
                "why": "single-tile PNG requests over HTTP, open-loop Poisson below the knee"}


@pytest.fixture(autouse=True)
def serving_cell(monkeypatch):
    """The harness reads BENCHMARK.json with the serving cell in it."""
    from torch_bench import harness

    load = harness.load_json

    def with_serving(rel):
        data = load(rel)
        if rel == "BENCHMARK.json":
            data["workloads"].append(SERVING_CELL)
        return data

    monkeypatch.setattr(harness, "load_json", with_serving)


@pytest.fixture
def run_small():
    """run_small(workload, control=, fault=, trace=) -> the result object of
    one small CPU run."""
    from torch_bench import harness

    def run(workload, control=None, fault=None, trace=0, seconds=1.5, seed=2**31 + 11):
        args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace,
                                  control=control, fault=fault)
        return harness.run_cell(args, time.perf_counter(), torch.device("cpu"), SMALL[workload])

    return run


@pytest.fixture
def small():
    """{workload: the overrides of its small CPU size}."""
    return SMALL
