"""The port's probes (P1-P5) against the JAX package's Mosaic probes.

scripts/probe_mosaic.py is imported by path; each of its probes runs its
Pallas kernel in TPU interpret mode on the CPU, on the script's own
arrays, and the port's plain version of the same probe is held to it:
P1-P3 sum in another order (1e-6 of the largest value), P4 and P5 round
once per product and sum, as XLA does (equal). On the CPU the wrappers
take the plain versions; ``cli/probe_cuda.py`` runs them against numpy.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from terra_gan_tpu_torch.cli import probe_cuda
from terra_gan_tpu_torch.ops.cuda import probe_kernels as pk

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "probe_mosaic.py"
SUM_TOL = 1e-6  # of max|value|: fp32 sums in another order


@pytest.fixture(scope="module")
def mosaic():
    spec = importlib.util.spec_from_file_location("probe_mosaic", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (the JAX probe's name, the port's plain version, its inputs from the
# script's arrays, exact)
CASES = [
    ("probe_lane_reduce", pk.probe_lane_reduce_plain, lambda m: (m.A, m.K1), False),
    ("probe_matvec_dot", pk.probe_matvec_dot_plain, lambda m: (m.A, m.K1.reshape(m.C, 1)), False),
    ("probe_lane_concat_dot", pk.probe_lane_concat_dot_plain,
     lambda m: (m.A, np.concatenate([m.K2, m.K2]).astype(np.float32)), False),
    ("probe_mask_broadcast", pk.probe_mask_broadcast_plain, lambda m: (m.A, m.M), True),
    ("probe_row_build", pk.probe_row_build_plain, lambda m: (m.A,), True),
]


@pytest.mark.parametrize("name,plain,inputs,exact", CASES, ids=[c[0] for c in CASES])
def test_plain_probe_matches_the_jax_probe_in_interpret_mode(mosaic, name, plain, inputs, exact):
    with pltpu.force_tpu_interpret_mode():
        got_jax, _ = getattr(mosaic, name)()
    got_jax = np.asarray(got_jax)
    ours = plain(*map(t, inputs(mosaic))).numpy()
    assert ours.shape == got_jax.shape and ours.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(ours, got_jax)
    else:
        assert np.abs(ours - got_jax).max() <= SUM_TOL * np.abs(got_jax).max()


def test_probe_inputs_are_the_scripts(mosaic):
    for ours, theirs in zip(probe_cuda.probe_inputs(), (mosaic.A, mosaic.K1, mosaic.K2, mosaic.M)):
        np.testing.assert_array_equal(ours, theirs)


def test_wrappers_take_the_plain_version_on_the_cpu_and_count_nothing():
    a, k1, k2, m = map(t, probe_cuda.probe_inputs())
    inputs = [(a, k1), (a, k1[:, None]), (a, torch.cat([k2, k2])), (a, m), (a,)]
    for fn, args in zip(pk.PROBES, inputs):
        before = fn.launches
        assert torch.equal(fn(*args), pk.PLAIN[fn](*args))
        assert fn.launches == before


def test_wrappers_raise_for_a_device_without_a_kernel():
    a = torch.empty((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pk.probe_row_build(a)


def test_probe_cli_prints_five_oks_and_exits_0_on_the_cpu(capsys):
    assert probe_cuda.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "lane_reduce (sum over C -> [rows,cols])", "matvec_dot  (dot K=C N=1 -> [rows,cols])",
        "lane_concat_dot (K=2C packed dot)", "mask_broadcast ([rows,cols] -> C lanes)",
        "row_build (static row-slice writes)"]
    assert all(": OK maxerr=" in ln for ln in lines)


def test_probe_cli_exits_1_when_a_probe_fails(monkeypatch, capsys):
    cases = probe_cuda.probe_cases

    def broken(*arrays):
        out = cases(*arrays)
        label, _, args, want, tol = out[3]
        out[3] = (label, lambda a, m: pk.probe_mask_broadcast(a, m) + 1e-3, args, want, tol)
        label, _, args, want, tol = out[4]
        out[4] = (label, lambda a: 1 / 0, args, want, tol)
        return out

    monkeypatch.setattr(probe_cuda, "probe_cases", broken)
    assert probe_cuda.main(["--device", "cpu"]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert "OK" in lines[0] and "FAIL maxerr=" in lines[3]
    assert lines[4] == "row_build (static row-slice writes): FAIL division by zero"


def test_probe_cli_raises_without_cuda_for_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe_cuda.main([])
