"""Repository-wide pytest hook, loaded for every test path under the repo.

The JAX package's native codec (``native/terra_io.cpp``) builds in place
on first use. Under xdist every worker that found it missing ran
``make`` at once, and a worker that opened the half-written library
skipped ``tests/test_native.py``. The controller (the one process
without ``workerinput``) builds it here, before the workers start, so
they find it built.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput") or not config.getoption("numprocesses", None):
        return
    from terra_gan_tpu.utils import native

    native.load_library()
