"""Repository-wide pytest hooks, loaded for every test path under the repo.

The JAX package's native codec (``native/terra_io.cpp``) builds in place
on first use. Under xdist every worker that found it missing ran
``make`` at once, and a worker that opened the half-written library
skipped ``tests/test_native.py``. The controller (the one process
without ``workerinput``) builds it here, before the workers start, so
they find it built.

Each xdist worker gets one fair share of the host's cores for torch:
left alone, torch starts every worker with a thread per core, and the
workers then fight each other for the cores. The share goes to torch's
intra- and inter-op pools and to ``OMP_NUM_THREADS``/``MKL_NUM_THREADS``,
which the subprocesses the tests start inherit. A serial run keeps
torch's defaults.

Every phase (setup, call, teardown) of a port test (``tests/test_torch_*.py``)
runs under ``PORT_TEST_LIMIT_S``: a hang fails that test by name, with
every thread's stack printed, instead of running the suite into its clock.
"""

import contextlib
import faulthandler
import os
import signal
import sys
import threading
import time
from pathlib import Path

import pytest

# At least twice the slowest phase of a port test under xdist's share: the
# f64 gate's subprocess fixture, 85 s with the port's files alone and 132 s
# in a whole tier-1 run (-n 6) on an 8-core host.
PORT_TEST_LIMIT_S = 300.0
PORT_TESTS = Path(__file__).resolve().parent / "tests"


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        share_cores(int(config.workerinput["workercount"]))
        return
    if not config.getoption("numprocesses", None):
        return
    from terra_gan_tpu.utils import native

    native.load_library()


def share_cores(workers: int) -> None:
    """Gives torch, and the subprocesses started from here, this process's
    share of the host's cores when ``workers`` processes run side by side."""
    share = max(1, (os.cpu_count() or 1) // workers)
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(share)
    import torch

    torch.set_num_threads(share)
    torch.set_num_interop_threads(share)


@contextlib.contextmanager
def time_limit(nodeid: str, seconds: float):
    """Fails ``nodeid`` if the block runs past ``seconds``.

    faulthandler prints every thread's stack at the limit, which shows a
    hang even in C code; in the main thread a SIGALRM then raises pytest's
    failure where the block is. A limit already armed around this one is
    re-armed with what is left of it on the way out."""
    def expire(signum, frame):
        pytest.fail(f"{nodeid} ran past its {seconds:g} s limit")

    main = threading.current_thread() is threading.main_thread()
    start = time.monotonic()
    faulthandler.dump_traceback_later(seconds, file=sys.__stderr__)
    if main:
        handler = signal.signal(signal.SIGALRM, expire)
        outer, _ = signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        if main:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, handler)
            if outer:
                left = max(outer - (time.monotonic() - start), 1e-3)
                faulthandler.dump_traceback_later(left, file=sys.__stderr__)
                signal.setitimer(signal.ITIMER_REAL, left)


def _limited(item):
    if item.path.parent != PORT_TESTS or not item.path.name.startswith("test_torch_"):
        return (yield)
    with time_limit(item.nodeid, PORT_TEST_LIMIT_S):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _limited(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _limited(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    return (yield from _limited(item))
