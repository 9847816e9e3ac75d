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
    """Seeded A, K1, M and K2 at ``shape`` through the loaded script's globals."""
    rows, cols, c = shape
    g = np.random.default_rng(seed)
    for name, value in (("ROWS", rows), ("COLS", cols), ("C", c),
                        ("A", g.random(shape, dtype=np.float32)),
                        ("K1", g.random((c,), dtype=np.float32)),
                        ("M", g.random((rows, cols), dtype=np.float32)),
                        ("K2", g.random((c, c), dtype=np.float32))):
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
    with pytest.raises(ValueError, match="int range"):
        pk.plan_probe("probe_row_build", torch.empty((2**16, 2**15 + 1), device="meta"))
    with pytest.raises(ValueError, match="no plan"):
        pk.plan_probe("probe_row_shuffle", torch.zeros((2, 4)))


def test_p2_p4_wrappers_take_the_plain_version_on_the_cpu_whatever_the_variant():
    a, k1, _, m = map(t, probe_cuda.probe_inputs())
    for fn, args in ((pk.probe_matvec_dot, (a, k1[:, None])), (pk.probe_mask_broadcast, (a, m))):
        before = dict(fn.variants)
        for variant in (None, *pk.VARIANTS):
            assert torch.equal(fn(*args, variant=variant), pk.PLAIN[fn](*args))
        assert fn.variants == before and set(before) == set(pk.VARIANTS)


# P5 redesigned: a float4 (vec4) or a float (scalar) a thread, the planner


def test_p5_plan_takes_vec4_for_rows_of_4_floats_at_16_bytes():
    a = torch.zeros((16, 64, 64))
    assert pk.plan_probe("probe_row_build", a) == ("vec4", 64, 256)  # 16384 float4s
    assert pk.plan_probe("probe_row_build", a, variant="scalar") == ("scalar", 256, 256)
    assert pk.plan_probe("probe_row_build", torch.zeros((300, 1000))) == ("vec4", 293, 256)
    assert pk.plan_probe("probe_row_build", torch.zeros((5, 4)))[0] == "vec4"


@pytest.mark.parametrize("shape", [(3, 5, 7, 33), (5, 6), (37,), (8,), (2, 2)])
def test_p5_plan_takes_scalar_for_other_rows_and_a_view_at_a_4_byte_offset(shape):
    a = torch.zeros(shape)
    assert pk.plan_probe("probe_row_build", a)[0] == "scalar"
    with pytest.raises(ValueError, match="vec4 needs"):
        pk.plan_probe("probe_row_build", a, variant="vec4")
    view = torch.zeros(1 + 16 * 64 * 64)[1:].view(16, 64, 64)
    assert view.data_ptr() % 16 == 4 and pk.plan_probe("probe_row_build", view)[0] == "scalar"
    with pytest.raises(ValueError, match="vec4 needs"):
        pk.plan_probe("probe_row_build", view, variant="vec4")
    with pytest.raises(ValueError, match="not one of"):
        pk.plan_probe("probe_row_build", a, variant="wide")


def emulated_row_build(a: torch.Tensor, variant: str, grid: int, block: int):
    """P5's kernel in plain torch: thread i < total takes float4 i (vec4) or
    element i (scalar); one before the last row reads i and i + row, the
    last row copies. (out, how many threads wrote each element)."""
    flat, w = a.reshape(-1), 4 if variant == "vec4" else 1
    row, total = a.numel() // a.shape[0] // w, a.numel() // w
    i = torch.arange(grid * block)
    i = i[i < total]
    j = (i[:, None] * w + torch.arange(w)).reshape(-1)  # the elements of each thread
    first = (i < total - row).repeat_interleave(w)
    out = torch.full_like(flat, float("nan"))
    nxt = flat[torch.where(first, j + row * w, j)]
    out[j] = torch.where(first, 0.25 * flat[j] + 0.75 * nxt, flat[j])
    return out.view(a.shape), torch.bincount(j, minlength=a.numel())


@pytest.mark.parametrize("shape", [(16, 64, 64), (3, 5, 7, 33), (1, 64), (37,), (5, 4),
                                   (300, 1000), (7, 5, 6)])
def test_p5_index_map_covers_every_element_once_and_gives_the_plain_bits(shape):
    a = torch.from_numpy(np.random.default_rng(len(shape)).random(shape, dtype=np.float32))
    want = pk.probe_row_build_plain(a)
    for variant in pk.VARIANTS:
        if variant == "vec4" and pk.plan_probe("probe_row_build", a)[0] != "vec4":
            continue
        _, grid, block = pk.plan_probe("probe_row_build", a, variant=variant)
        got, writes = emulated_row_build(a, variant, grid, block)
        assert (writes == 1).all()
        assert torch.equal(got, want)
        assert (grid - 1) * block < a.numel() // (4 if variant == "vec4" else 1) <= grid * block


def test_p5_wrapper_takes_the_plain_version_on_the_cpu_whatever_the_variant():
    a = t(probe_cuda.probe_inputs()[0])
    before = dict(pk.probe_row_build.variants), pk.probe_row_build.launches
    for variant in (None, *pk.VARIANTS):
        assert torch.equal(pk.probe_row_build(a, variant=variant), pk.probe_row_build_plain(a))
    assert (pk.probe_row_build.variants, pk.probe_row_build.launches) == before
    assert set(before[0]) == set(pk.VARIANTS)


# P1 and P3 redesigned: P1 on P2's kernel, P3's tiles and sum order, the planner


def script_k2(mosaic) -> np.ndarray:
    """The k2 the JAX P3 probe takes: [K2; K2], [2C, C]."""
    return np.concatenate([mosaic.K2, mosaic.K2]).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
@pytest.mark.parametrize("name", ["probe_lane_reduce", "probe_lane_concat_dot"])
def test_plain_p1_p3_match_the_jax_probe_at_other_shapes(mosaic, monkeypatch, name, shape):
    set_shape(monkeypatch, mosaic, shape, seed=sum(shape))
    want = jax_probe(mosaic, name)
    if name == "probe_lane_reduce":
        ours = pk.probe_lane_reduce_plain(t(mosaic.A), t(mosaic.K1)).numpy()
        assert ours.shape == want.shape == shape[:2]
    else:
        ours = pk.probe_lane_concat_dot_plain(t(mosaic.A), t(script_k2(mosaic))).numpy()
        assert ours.shape == want.shape == shape
    assert np.abs(ours - want).max() <= SUM_TOL * np.abs(want).max()


@pytest.mark.parametrize("shape,variant", EMULATED,
                         ids=[f"{'x'.join(map(str, s))}-{v}" for s, v in EMULATED])
def test_p1_kernel_sum_order_matches_the_jax_probe(mosaic, monkeypatch, shape, variant):
    # P1 launches P2's kernel on k [C], the memory of k [C, 1]
    set_shape(monkeypatch, mosaic, shape, seed=sum(shape))
    want = jax_probe(mosaic, "probe_lane_reduce")
    got = emulated_matvec_dot(t(mosaic.A), t(mosaic.K1).reshape(-1, 1), variant).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= SUM_TOL * np.abs(want).max()


def fmaf(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """fmaf as the f64 sum of the exact product rounded to fp32 (a double
    rounding the kernel does not make, far below the gate)."""
    return (x.double() * w.double() + s.double()).float()


def emulated_lane_concat_dot(a: torch.Tensor, k2: torch.Tensor, variant: str):
    """P3's kernel in plain torch as plan_probe tiles it: (out, the plan,
    how often the grid writes each output). Block b takes row tile
    b // col_tiles and column tile b % col_tiles; it stages, chunk by chunk
    (kchunk columns of a, padded to a multiple of 4 with zeros), its rows
    of a and k2's rows j and C + j at its columns, zero past the tensors'
    ends (in vec4 every float4 lies wholly inside or outside, so its
    copies stage what the scalar ones do); for each output one thread sums
    lo += a * k2[j] and another hi += 2a * k2[C + j], by fmaf in ascending
    j over the chunks (a padded slot adds 0 * 0), and the first writes
    lo + hi. Every block's arithmetic is
    the same, so the blocks are emulated side by side on the padded tiles."""
    c = a.shape[-1]
    rows2 = a.reshape(-1, c)
    m, n = rows2.shape[0], k2.shape[1]
    plan = pk.plan_probe("probe_lane_concat_dot", a, k2, variant=variant)
    _, grid, block, rows, kchunk = plan
    bn = 4 * (block // (2 * rows))  # two groups of threads, one a half of the concat
    col_tiles = -(-n // bn)
    if variant == "vec4":
        assert c % 4 == 0 and n % 4 == 0 and kchunk % 4 == 0
    written = np.zeros((-(-m // rows) * rows, col_tiles * bn), np.int64)
    for b in range(grid):
        row0, col0 = (b // col_tiles) * rows, (b % col_tiles) * bn
        written[row0:row0 + rows, col0:col0 + bn] += 1
    tiles_a = torch.zeros((written.shape[0], c))  # the row tiles, zero past m
    tiles_a[:m] = rows2
    tiles_k = torch.zeros((2 * c, written.shape[1]))  # the column tiles, zero past n
    tiles_k[:, :n] = k2
    lo = torch.zeros(written.shape)
    hi = torch.zeros(written.shape)
    for j0 in range(0, c, kchunk):
        kc = min(kchunk, c - j0)
        for jj in range(-(-kc // 4) * 4):
            if jj < kc:
                v, w0, w1 = tiles_a[:, j0 + jj:j0 + jj + 1], tiles_k[j0 + jj], tiles_k[c + j0 + jj]
            else:  # a padded slot of the chunk
                v, w0, w1 = torch.zeros((lo.shape[0], 1)), torch.zeros(lo.shape[1]), \
                    torch.zeros(lo.shape[1])
            lo = fmaf(v, w0, lo)
            hi = fmaf(v * 2.0, w1, hi)
    out = (lo + hi)[:m, :n]
    return out.reshape(*a.shape[:-1], n), plan, torch.from_numpy(written[:m, :n])


# (ROWS, COLS, C = N): the script's; odd C, N not a multiple of the tile; M
# = 1001, not a multiple of R; k2 past the shared budget (K in chunks of 68,
# the last 64), and so at odd C (the last chunk 65, padded to 68); one row
P3_SHAPES = [(16, 64, 64), (3, 5, 33), (7, 143, 12), (8, 64, 200), (4, 128, 201), (1, 1, 4)]
P3_EMULATED = [(s, v) for s in P3_SHAPES for v in pk.VARIANTS if v == "scalar" or s[2] % 4 == 0]


@pytest.mark.parametrize("shape,variant", P3_EMULATED,
                         ids=[f"{'x'.join(map(str, s))}-{v}" for s, v in P3_EMULATED])
def test_p3_kernel_tiling_and_sum_order_match_the_jax_probe(mosaic, monkeypatch, shape,
                                                             variant):
    set_shape(monkeypatch, mosaic, shape, seed=sum(shape))
    want = jax_probe(mosaic, "probe_lane_concat_dot")
    a, k2 = t(mosaic.A).clone(), t(script_k2(mosaic)).clone()  # 64-byte aligned
    got, (_, grid, block, rows, kchunk), written = emulated_lane_concat_dot(a, k2, variant)
    assert torch.equal(written, torch.ones_like(written))  # every output once
    m, c = shape[0] * shape[1], shape[2]
    assert (kchunk < c) == (c >= 200)  # only there K goes in chunks
    if shape == (7, 143, 12):
        assert rows > 1 and m % rows != 0
    got = got.numpy()
    assert got.shape == want.shape == shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= SUM_TOL * np.abs(want).max()


def test_p3_emulation_sums_each_half_in_order_then_adds_them():
    # one row, C = 3, N = 1, exact in fp32: lo = 1*1 + 2*2 + 3*3, hi = 2*(1*4 + 2*5 + 3*6)
    a = torch.tensor([[1.0, 2.0, 3.0]])
    k2 = torch.tensor([[1.0], [2.0], [3.0], [4.0], [5.0], [6.0]])
    got, plan, written = emulated_lane_concat_dot(a, k2, "scalar")
    assert written.tolist() == [[1]]
    assert plan == ("scalar", 1, 2, 1, 3)
    assert got.tolist() == [[14.0 + 64.0]]
    assert torch.equal(got, pk.probe_lane_concat_dot_plain(a, k2))


@pytest.mark.parametrize("name", ["probe_lane_reduce", "probe_lane_concat_dot"])
def test_plan_p1_p3_take_vec4_and_scalar_by_c_and_alignment(name):
    def other(c, n=None):
        return torch.zeros(c) if name == "probe_lane_reduce" else torch.zeros((2 * c, n or c))

    a = torch.zeros((16, 64, 64))
    assert pk.plan_probe(name, a, other(64))[0] == "vec4"
    assert pk.plan_probe(name, a, other(64), variant="scalar")[0] == "scalar"
    assert pk.plan_probe(name, torch.zeros((3, 5, 7, 33)), other(33))[0] == "scalar"
    view = torch.zeros(1 + 16 * 64 * 64)[1:].view(16, 64, 64)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    assert pk.plan_probe(name, view, other(64))[0] == "scalar"
    with pytest.raises(ValueError, match="vec4 needs"):
        pk.plan_probe(name, view, other(64), variant="vec4")
    with pytest.raises(ValueError, match="not one of"):
        pk.plan_probe(name, a, other(64), variant="wide")
    # the float4-read weight at a 4-byte offset: scalar
    w = other(64)
    w_view = torch.zeros(1 + w.numel())[1:].view(w.shape)
    assert pk.plan_probe(name, a, w_view)[0] == "scalar"
    if name == "probe_lane_concat_dot":  # k2's rows float4s only at N % 4 == 0
        assert pk.plan_probe(name, a, other(64, 37))[0] == "scalar"
        assert pk.plan_probe(name, a, other(64, 36))[0] == "vec4"


@pytest.mark.parametrize("n,c", [(1, 64), (1024, 64), (105, 33), (7, 4), (40000, 64)])
def test_plan_p1_is_p2s(n, c):
    a = torch.zeros((n, c))
    assert pk.plan_probe("probe_lane_reduce", a, torch.zeros(c)) == \
        pk.plan_probe("probe_matvec_dot", a, torch.zeros((c, 1)))


def p3_outputs_visited(m: int, n: int, grid: int, block: int, rows: int) -> np.ndarray:
    """How often P3's grid writes each output: block b takes row tile
    b // col_tiles and column tile b % col_tiles, thread (r, q) its row r
    and column quad q, inside the tensor."""
    bq = block // (2 * rows)
    bn, col_tiles = 4 * bq, -(-n // (4 * bq))
    seen = np.zeros((m, n), np.int64)
    for b in range(grid):
        r0, c0 = (b // col_tiles) * rows, (b % col_tiles) * bn
        seen[r0:r0 + rows, c0:c0 + bn] += 1
    return seen


@pytest.mark.parametrize("m,c,n", [(1024, 64, 64), (105, 33, 37), (1001, 12, 12),
                                   (6, 200, 200), (1, 1, 1), (40000, 64, 64), (3, 90, 300),
                                   (133, 5, 70)])
def test_plan_p3_grid_covers_every_output_once(m, c, n):
    variant, grid, block, rows, kchunk = pk.plan_probe(
        "probe_lane_concat_dot", torch.zeros((m, c)), torch.zeros((2 * c, n)))
    assert variant == ("vec4" if c % 4 == 0 and n % 4 == 0 else "scalar")
    assert rows in pk.CONCAT_ROWS and block % (2 * rows) == 0 and block <= pk.CONCAT_THREADS
    bq = block // (2 * rows)
    assert bq & (bq - 1) == 0 and bq <= pk.CONCAT_MAX_QUADS
    assert bq == 1 or 2 * bq < n  # no wider than the least BQ that covers N
    np.testing.assert_array_equal(p3_outputs_visited(m, n, grid, block, rows), 1)
    # one stage where it fits, else two of a multiple of 4 below C, the most that fit
    one = pk.concat_smem_bytes(rows, bq, -(-c // 4) * 4, 1)
    if kchunk == c:
        assert one <= pk.CONCAT_SMEM_BUDGET
    else:
        assert one > pk.CONCAT_SMEM_BUDGET and kchunk % 4 == 0 and 4 <= kchunk < c
        assert pk.concat_smem_bytes(rows, bq, kchunk, 2) <= pk.CONCAT_SMEM_BUDGET
        assert pk.concat_smem_bytes(rows, bq, kchunk + 4, 2) > pk.CONCAT_SMEM_BUDGET \
            or kchunk + 4 >= c


@pytest.mark.parametrize("m,c,n", [(1024, 64, 64), (1000, 64, 64), (105, 33, 37), (133, 64, 64),
                                   (1, 64, 64), (4096, 64, 64), (16, 64, 64), (1024, 8, 300)])
def test_plan_p3_stages_the_fewest_bytes_on_the_busiest_sm(m, c, n):
    _, grid, block, rows, _ = pk.plan_probe("probe_lane_concat_dot", torch.zeros((m, c)),
                                            torch.zeros((2 * c, n)))
    bq = block // (2 * rows)
    least = 1
    while least < pk.CONCAT_MAX_QUADS and 4 * least < n:
        least *= 2
    every = [pk.concat_busiest_sm_bytes(m, c, n, r, q) for r in pk.CONCAT_ROWS
             for q in (1, 2, 4, 8, 16) if q <= least and 2 * r * q <= pk.CONCAT_THREADS]
    assert pk.concat_busiest_sm_bytes(m, c, n, rows, bq) == min(every)
    if (m, c, n) == (1024, 64, 64):  # the probe's: 16 rows by 32 columns, 128 blocks of 20 KB
        assert (rows, bq, grid) == (16, 8, 128)
        assert pk.concat_busiest_sm_bytes(m, c, n, rows, bq) == 4 * (16 * 64 + 128 * 32)


def test_plan_p1_p3_raise_above_the_int_range():
    big = torch.empty((2**16, 2**15 + 1), device="meta")
    with pytest.raises(ValueError, match="int range"):
        pk.plan_probe("probe_lane_reduce", big, torch.empty(2**15 + 1, device="meta"))
    a = torch.empty((2**16, 8), device="meta")  # 2^16 rows x 2^15 columns of output
    with pytest.raises(ValueError, match="outputs, above the kernel's int range"):
        pk.plan_probe("probe_lane_concat_dot", a, torch.empty((16, 2**15), device="meta"))
    k2 = torch.empty((2**16, 2**15), device="meta")  # 2^31 elements of k2
    with pytest.raises(ValueError, match="int range"):
        pk.plan_probe("probe_lane_concat_dot", torch.empty((1, 2**15), device="meta"), k2)


def test_p1_p3_wrappers_take_the_plain_version_on_the_cpu_whatever_the_variant():
    a, k1, k2, _ = map(t, probe_cuda.probe_inputs())
    for fn, args in ((pk.probe_lane_reduce, (a, k1)),
                     (pk.probe_lane_concat_dot, (a, torch.cat([k2, k2])))):
        before, launches = dict(fn.variants), fn.launches
        for variant in (None, *pk.VARIANTS):
            assert torch.equal(fn(*args, variant=variant), pk.PLAIN[fn](*args))
        assert fn.variants == before and set(before) == set(pk.VARIANTS)
        assert fn.launches == launches
