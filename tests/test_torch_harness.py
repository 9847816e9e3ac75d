"""The repo-root conftest.py's harness for the port's tests: each xdist
worker's share of the host's cores for torch, and the time limit on every
phase of a port test (driven here through its helper with a short limit)."""

from __future__ import annotations

import importlib.util
import os
import signal
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def harness():
    spec = importlib.util.spec_from_file_location("repo_conftest", ROOT / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_an_xdist_worker_runs_torch_on_its_share_of_the_cores():
    if "PYTEST_XDIST_WORKER_COUNT" not in os.environ:
        pytest.skip("a serial run keeps torch's own thread count")
    share = max(1, os.cpu_count() // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    assert torch.get_num_threads() == share
    assert torch.get_num_interop_threads() == share
    assert os.environ["OMP_NUM_THREADS"] == os.environ["MKL_NUM_THREADS"] == str(share)


def test_the_time_limit_fails_the_item_by_name(harness):
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match=r"tests/x\.py::hangs ran past its 0\.2 s limit"):
        with harness.time_limit("tests/x.py::hangs", 0.2):
            time.sleep(30)
    assert time.monotonic() - start < 10
    # this test's own limit, armed around the call, is armed again
    assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= harness.PORT_TEST_LIMIT_S


def test_a_block_inside_its_limit_leaves_the_alarm_as_it_was(harness):
    before = signal.getsignal(signal.SIGALRM), signal.getitimer(signal.ITIMER_REAL)[0]
    with harness.time_limit("tests/x.py::quick", 5.0):
        time.sleep(0.01)
    handler, left = signal.getsignal(signal.SIGALRM), signal.getitimer(signal.ITIMER_REAL)[0]
    assert handler is before[0]
    assert 0 < left <= before[1]
