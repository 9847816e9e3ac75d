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


# P2 and P4 redesigned: the JAX probes at other shapes, P2's sum order, the planner

# (ROWS, COLS, C): the script's own, then odd C, a single row and a wider C
SHAPES = [(16, 64, 64), (3, 5, 33), (1, 1, 4), (2, 3, 128)]


def set_shape(monkeypatch, mosaic, shape, seed):
    """Seeded A, K1, M at ``shape`` through the loaded script's globals."""
    rows, cols, c = shape
    g = np.random.default_rng(seed)
    for name, value in (("ROWS", rows), ("COLS", cols), ("C", c),
                        ("A", g.random(shape, dtype=np.float32)),
                        ("K1", g.random((c,), dtype=np.float32)),
                        ("M", g.random((rows, cols), dtype=np.float32))):
        monkeypatch.setattr(mosaic, name, value)


def jax_probe(mosaic, name):
    with pltpu.force_tpu_interpret_mode():
        got, _ = getattr(mosaic, name)()
    return np.asarray(got)


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
@pytest.mark.parametrize("name", ["probe_matvec_dot", "probe_mask_broadcast"])
def test_plain_p2_p4_match_the_jax_probe_at_other_shapes(mosaic, monkeypatch, name, shape):
    set_shape(monkeypatch, mosaic, shape, seed=sum(shape))
    want = jax_probe(mosaic, name)
    if name == "probe_matvec_dot":
        ours = pk.probe_matvec_dot_plain(t(mosaic.A), t(mosaic.K1.reshape(-1, 1))).numpy()
        assert ours.shape == want.shape == shape[:2]
        assert np.abs(ours - want).max() <= SUM_TOL * np.abs(want).max()
    else:
        ours = pk.probe_mask_broadcast_plain(t(mosaic.A), t(mosaic.M)).numpy()
        assert ours.shape == want.shape == shape
        np.testing.assert_array_equal(ours, want)


def emulated_matvec_dot(a: torch.Tensor, k: torch.Tensor, variant: str) -> torch.Tensor:
    """P2's kernel arithmetic in plain torch: a row's L lanes each sum their
    elements in order with fmaf (vec4: lane l takes float4s l, l + L, ...;
    scalar: elements l, l + L, ...), then the xor-shuffle tree adds the
    partial sums, s[l] + s[l ^ off] for off = L/2 .. 1, and lane 0 keeps
    the row's. fmaf is the f64 sum of the exact product rounded to fp32
    (a double rounding the kernel does not make, far below the gate)."""
    c = a.shape[-1]
    lanes = pk.matvec_lanes(c)
    rows, kk = a.reshape(-1, c).double(), k[:, 0].double()
    s = torch.zeros((rows.shape[0], lanes), dtype=torch.float32)
    for j in range(c):  # each lane's elements come in ascending order
        lane = (j // 4) % lanes if variant == "vec4" else j % lanes
        s[:, lane] = (s[:, lane].double() + rows[:, j] * kk[j]).float()
    idx = torch.arange(lanes)
    off = lanes // 2
    while off:
        s = s + s[:, idx ^ off]
        off //= 2
    return s[:, 0].reshape(a.shape[:-1])


EMULATED = [(s, v) for s in SHAPES for v in pk.VARIANTS if v == "scalar" or s[2] % 4 == 0]


@pytest.mark.parametrize("shape,variant", EMULATED,
                         ids=[f"{'x'.join(map(str, s))}-{v}" for s, v in EMULATED])
def test_p2_kernel_sum_order_matches_the_jax_probe(mosaic, monkeypatch, shape, variant):
    set_shape(monkeypatch, mosaic, shape, seed=sum(shape))
    want = jax_probe(mosaic, "probe_matvec_dot")
    got = emulated_matvec_dot(t(mosaic.A), t(mosaic.K1.reshape(-1, 1)), variant).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= SUM_TOL * np.abs(want).max()


def test_p2_emulation_groups_lanes_as_the_kernel_does():
    # C = 64: 16 lanes of one float4; C = 33: 16 lanes; C = 4: one lane
    assert [pk.matvec_lanes(c) for c in (1, 4, 5, 33, 64, 128, 129, 4096)] == \
        [1, 1, 2, 16, 16, 32, 32, 32]
    # with one lane the kernel's order is numpy's sequential one
    a = torch.from_numpy(np.random.default_rng(3).random((5, 4), dtype=np.float32))
    k = torch.ones((4, 1))
    want = ((a[:, 0] + a[:, 1]) + a[:, 2]) + a[:, 3]
    assert torch.equal(emulated_matvec_dot(a, k, "scalar"), want)


@pytest.mark.parametrize("name,other", [("probe_matvec_dot", (64, 1)),
                                        ("probe_mask_broadcast", (16, 64))])
def test_plan_takes_vec4_for_aligned_c64(name, other):
    a, o = torch.zeros((16, 64, 64)), torch.zeros(other)
    assert pk.plan_probe(name, a, o) == ("vec4", 128, 128)  # 1024 rows, 16384 float4s
    assert pk.plan_probe(name, a, o, variant="scalar")[0] == "scalar"


@pytest.mark.parametrize("name", ["probe_matvec_dot", "probe_mask_broadcast"])
def test_plan_takes_scalar_for_odd_c_and_a_view_at_a_4_byte_offset(name):
    a = torch.zeros((3, 5, 7, 33))
    other = torch.zeros((33, 1)) if name == "probe_matvec_dot" else torch.zeros((3, 5, 7))
    assert pk.plan_probe(name, a, other)[0] == "scalar"
    view = torch.zeros(1 + 16 * 64 * 64)[1:].view(16, 64, 64)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    other = torch.zeros((64, 1)) if name == "probe_matvec_dot" else torch.zeros((16, 64))
    assert pk.plan_probe(name, view, other)[0] == "scalar"
    with pytest.raises(ValueError, match="vec4 needs"):
        pk.plan_probe(name, view, other, variant="vec4")
    with pytest.raises(ValueError, match="not one of"):
        pk.plan_probe(name, a, other, variant="wide")


def test_plan_looks_at_k_for_p2_only():
    a = torch.zeros((4, 64))
    k = torch.zeros(1 + 64)[1:].view(64, 1)  # k at a 4-byte offset: P2 reads it as float4s
    assert pk.plan_probe("probe_matvec_dot", a, k)[0] == "scalar"
    m = torch.zeros(1 + 4)[1:]  # P4 reads m a float at a time
    assert pk.plan_probe("probe_mask_broadcast", a, m)[0] == "vec4"


def p2_rows_visited(n: int, c: int, grid: int, block: int):
    """The rows P2's grid-stride loop gives a group, over the whole grid."""
    per_warp = 32 // pk.matvec_lanes(c)
    stride = grid * block // 32 * per_warp
    rows = np.concatenate([np.arange(r0, r0 + per_warp) for w in range(grid * block // 32)
                           for r0 in range(w * per_warp, n, stride)] or [np.arange(0)])
    return np.sort(rows[rows < n])


@pytest.mark.parametrize("n,c", [(1, 64), (1024, 64), (105, 33), (7, 4), (6, 128),
                                 (40000, 64), (300000, 1)])
def test_plan_grid_covers_every_row_once(n, c):
    variant, grid, block = pk.plan_probe("probe_matvec_dot", torch.zeros((n, c)),
                                         torch.zeros((c, 1)))
    assert block == pk.PROBE_THREADS and 1 <= grid <= pk.MAX_PROBE_BLOCKS
    np.testing.assert_array_equal(p2_rows_visited(n, c, grid, block), np.arange(n))
    if grid < pk.MAX_PROBE_BLOCKS:  # one pass, and no block without a row
        per_block = block // pk.matvec_lanes(c)
        assert grid * per_block >= n > (grid - 1) * per_block
    items = n * c // 4 if c % 4 == 0 else n * c  # P4: a float4 or an element a thread
    _, grid4, _ = pk.plan_probe("probe_mask_broadcast", torch.zeros((n, c)), torch.zeros(n))
    assert grid4 == min(-(-items // block), pk.MAX_PROBE_BLOCKS)


def test_plan_raises_above_the_int_range_and_for_other_probes():
    big = torch.empty((2**16, 2**15 + 1), device="meta")
    for name, other in (("probe_matvec_dot", torch.empty((2**15 + 1, 1), device="meta")),
                        ("probe_mask_broadcast", torch.empty(2**16, device="meta"))):
        with pytest.raises(ValueError, match="int range"):
            pk.plan_probe(name, big, other)
    with pytest.raises(ValueError, match="no plan"):
        pk.plan_probe("probe_row_build", torch.zeros((2, 4)))


def test_p2_p4_wrappers_take_the_plain_version_on_the_cpu_whatever_the_variant():
    a, k1, _, m = map(t, probe_cuda.probe_inputs())
    for fn, args in ((pk.probe_matvec_dot, (a, k1[:, None])), (pk.probe_mask_broadcast, (a, m))):
        before = dict(fn.variants)
        for variant in (None, *pk.VARIANTS):
            assert torch.equal(fn(*args, variant=variant), pk.PLAIN[fn](*args))
        assert fn.variants == before and set(before) == set(pk.VARIANTS)
