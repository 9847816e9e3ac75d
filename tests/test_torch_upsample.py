"""K1's walk and launch plan (terra_gan_tpu_torch/ops/cuda/upsample_kernel.py) against the JAX kernels.

The CUDA kernels of csrc/upsample2x.cu run only on a card; here their
arithmetic and data movement are emulated in numpy, thread by thread as
the kernels walk, and held to torch's source indices and weights, to the
plain versions, to the JAX package's Pallas kernels in interpret mode and
to the JAX package's custom_vjp. ``plan_upsample`` is held to cover every
output exactly once within 32-bit indices. Inputs are seeded numpy.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from terra_gan_tpu.ops import resize as jresize
from terra_gan_tpu.ops.pallas.upsample_kernel import (
    upsample2x_bwd_pallas,
    upsample2x_fwd_pallas,
)
from terra_gan_tpu_torch.ops.cuda.upsample_kernel import (
    INT_MAX,
    MAX_THREADS,
    plan_upsample,
    upsample2x_bwd_plain,
    upsample2x_fwd_plain,
)

# the 7 decoder upsamples' inputs (H, C) of the full-width 512^2 model
DECODER_SHAPES = [(4, 512), (8, 512), (16, 512), (32, 512), (64, 256), (128, 128), (256, 64)]
ODD_SIZES = [(1, 1), (2, 3), (5, 7), (3, 16)]
WALK_SIZES = [(h, h) for h, _ in DECODER_SHAPES] + ODD_SIZES
NARROW_C = 4  # the walk's indices do not depend on C; a narrow C keeps numpy quick
REL_TOL = 1e-6  # of max|reference|: fp32 taps summed in another order


def f32(v):
    return np.asarray(v, np.float32)


def fma(a, b, c):
    """fp32 fused multiply-add: the exact product and sum, rounded once."""
    return f32(np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64))


def mul(a, b):
    return f32(f32(a) * f32(b))


def torch_taps(n_out: int, n_in: int):
    """Torch's source index and weights per output along one axis
    (area_pixel_compute_source_index with scale 1/2, align_corners=False):
    (i0, i1, w0, w1), each an array over the n_out outputs."""
    o = np.arange(n_out, dtype=np.float32)
    s = np.maximum(f32(f32(np.float32(0.5) * f32(o + np.float32(0.5))) - np.float32(0.5)),
                   np.float32(0.0))
    i0 = s.astype(np.int64)
    i1 = i0 + (i0 < n_in - 1)
    w1 = f32(s - i0.astype(np.float32))
    return i0, i1, f32(np.float32(1.0) - w1), w1


def fwd_quads(h: int, w: int):
    """The forward kernel, emulated for every thread at once (one thread
    an input pixel (i, j)): the rows and columns of its 3x3 window,
    clamped, and the taps fwd_quad takes from it for each output of its
    quad. Returns (y0, y1, wy0, wy1) per output row, (x0, x1, wx0, wx1)
    per output column, each as [2h, 2w] arrays, and how many times each
    output was written."""
    y0, y1, x0, x1 = (np.full((2 * h, 2 * w), -1, np.int64) for _ in range(4))
    wy0, wy1, wx0, wx1 = (np.full((2 * h, 2 * w), np.nan, np.float32) for _ in range(4))
    count = np.zeros((2 * h, 2 * w), np.int64)
    i, j = (a.ravel() for a in np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))

    def taps(k, n):
        """(tap, tap, weight, weight) of outputs 2k and 2k+1 from the
        window's (k-1, k, k+1), clamped; TOP or LEFT where k == 0."""
        win, edge = [np.maximum(k - 1, 0), k, np.minimum(k + 1, n - 1)], k == 0
        return [(np.where(edge, win[1], win[0]), np.where(edge, win[2], win[1]),
                 np.where(edge, 1.0, 0.25), np.where(edge, 0.0, 0.75)),
                (win[1], win[2], np.full(k.shape, 0.75), np.full(k.shape, 0.25))]

    for dy, (ra, rb, a0, a1) in enumerate(taps(i, h)):
        for dxo, (ca, cb, b0, b1) in enumerate(taps(j, w)):
            oy, ox = 2 * i + dy, 2 * j + dxo
            y0[oy, ox], y1[oy, ox], wy0[oy, ox], wy1[oy, ox] = ra, rb, a0, a1
            x0[oy, ox], x1[oy, ox], wx0[oy, ox], wx1[oy, ox] = ca, cb, b0, b1
            np.add.at(count, (oy, ox), 1)
    return (y0, y1, wy0, wy1), (x0, x1, wx0, wx1), count


def fwd_values(x: np.ndarray, taps_y, taps_x) -> np.ndarray:
    """Each output from its four taps with the kernel's expression:
    fma(wy0, fma(wx1, a01, wx0*a00), wy1 * fma(wx0, a10, wx1*a11))."""
    (y0, y1, wy0, wy1), (x0, x1, wx0, wx1) = taps_y, taps_x
    a00, a01, a10, a11 = x[:, y0, x0], x[:, y0, x1], x[:, y1, x0], x[:, y1, x1]
    wy0, wy1, wx0, wx1 = (v[None, ..., None] for v in (wy0, wy1, wx0, wx1))
    r0 = fma(wx1, a01, mul(wx0, a00))
    r1 = fma(wx0, a10, mul(wx1, a11))
    return fma(wy0, r0, mul(wy1, r1))


def bwd_gather(g: np.ndarray, rows: int):
    """The adjoint kernel, emulated for every thread at once (one thread
    per block of ``rows`` dx rows and dx column, over the images and
    channels): each of its 2*rows+2 g rows summed over its 4 columns in
    order, then each dx row over its 4 g rows in order, one FMA a term.
    Returns dx and how many times each dx pixel was written."""
    n, gh, gw, c = g.shape
    h, w = gh // 2, gw // 2
    dx = np.full((n, h, w, c), np.nan, np.float32)
    count = np.zeros((h, w), np.int64)
    taps = (0.25, 0.75, 0.75, 0.25)
    i0, j = (a.ravel() for a in np.meshgrid(np.arange(0, h, rows), np.arange(w), indexing="ij"))
    cols = [np.maximum(2 * j - 1, 0), 2 * j, 2 * j + 1, np.minimum(2 * j + 2, gw - 1)]
    acc = [None] * rows
    for k in range(2 * rows + 2):
        r = np.clip(2 * i0 - 1 + k, 0, gh - 1)
        row_sum = fma(taps[0], g[:, r, cols[0]], 0.0)
        for t in range(1, 4):
            row_sum = fma(taps[t], g[:, r, cols[t]], row_sum)
        for s in range(rows):
            a = k - 2 * s
            if a == 0:
                acc[s] = fma(taps[0], row_sum, 0.0)
            elif 0 < a < 4:
                acc[s] = fma(taps[a], row_sum, acc[s])
    for s in range(rows):
        ok = i0 + s < h
        dx[:, (i0 + s)[ok], j[ok]] = acc[s][:, ok]
        np.add.at(count, ((i0 + s)[ok], j[ok]), 1)
    return dx, count


def max_rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("h,w", WALK_SIZES)
def test_forward_quads_take_torchs_taps_and_give_the_plain_result(h, w):
    """(a) At every output the taps and weights a thread takes from its
    window are torch's source index and weights exactly, each output is
    written once, and the fp32 result is the plain version's."""
    x = np.random.default_rng(h * 100 + w).standard_normal((2, h, w, NARROW_C)).astype(np.float32)
    want = upsample2x_fwd_plain(torch.from_numpy(x)).numpy()
    taps_y, taps_x, count = fwd_quads(h, w)
    assert (count == 1).all()
    for got_t, ref in zip(taps_y, torch_taps(2 * h, h)):
        np.testing.assert_array_equal(got_t, np.broadcast_to(ref[:, None], got_t.shape))
    for got_t, ref in zip(taps_x, torch_taps(2 * w, w)):
        np.testing.assert_array_equal(got_t, np.broadcast_to(ref[None, :], got_t.shape))
    got = fwd_values(x, taps_y, taps_x)
    assert got.shape == want.shape
    assert max_rel(got, want) <= REL_TOL


@pytest.mark.parametrize("h,w", WALK_SIZES)
def test_backward_gather_matches_plain_pallas_and_jax_vjp(h, w):
    """(b) The adjoint's gather, at 1 and 2 dx rows a thread, against the
    plain version, the Pallas adjoint in interpret mode (where its row
    blocks take H) and the JAX custom_vjp."""
    g = np.random.default_rng(h * 100 + w + 1).standard_normal(
        (2, 2 * h, 2 * w, NARROW_C)).astype(np.float32)
    refs = [upsample2x_bwd_plain(torch.from_numpy(g)).numpy()]
    (vjp,) = jax.vjp(jresize.upsample2x_bilinear, jnp.zeros((2, h, w, NARROW_C)))[1](jnp.asarray(g))
    refs.append(np.asarray(vjp))
    if h % min(4, h) == 0:  # the Pallas adjoint's blocks of min(4, H) rows
        refs.append(np.asarray(upsample2x_bwd_pallas(jnp.asarray(g), interpret=True)))
    for rows in (1, 2):
        got, count = bwd_gather(g, rows)
        assert (count == 1).all(), rows
        for ref in refs:
            assert got.shape == ref.shape
            assert max_rel(got, ref) <= REL_TOL, rows


def kernel_threads(plan, nb: int, h: int, w: int, groups: int):
    """The (image, first row, column, group) of every thread of a launch
    of nb images that the kernels' locate() keeps, from its block and
    thread index as locate() computes them."""
    grid = nb * plan.tiles_h * plan.tiles_w
    bx, by, t = (a.ravel() for a in np.meshgrid(np.arange(grid), np.arange(plan.slices),
                                                np.arange(plan.block), indexing="ij"))
    q, g = t // plan.gb, by * plan.gb + t % plan.gb
    b = bx // plan.tiles_w
    j = (bx % plan.tiles_w) * plan.rt + q % plan.rt
    i0 = ((b % plan.tiles_h) * plan.ht + q // plan.rt) * plan.rows
    n = b // plan.tiles_h
    live = (n < nb) & (i0 < h) & (j < w) & (g < groups)
    return n[live], i0[live], j[live], g[live]


def check_plan(direction: str, n: int, h: int, w: int, c: int, dtype) -> None:
    """The plan's launches tile the batch, each within 32-bit indices and
    with its grid of tiles; its blocks hold at most MAX_THREADS threads
    and its slices every channel group; its kept threads are distinct
    (image, row block, column, group) tuples, all of them; its row blocks
    and columns cover every output once."""
    plan = plan_upsample(direction, n, h, w, c, dtype)
    vec = 4 if dtype == torch.float32 else 8
    groups = c // vec
    row_blocks = -(-h // plan.rows)
    assert plan.vec == vec and plan.rows in ((1,) if direction == "fwd" else (1, 2))
    assert plan.block == plan.gb * plan.rt * plan.ht <= MAX_THREADS
    assert plan.gb * (plan.slices - 1) < groups <= plan.gb * plan.slices
    assert [n0 for n0, _, _ in plan.chunks] == list(np.cumsum([0] + [nb for _, nb, _ in plan.chunks])[:-1])
    assert sum(nb for _, nb, _ in plan.chunks) == n
    for _, nb, grid in plan.chunks:
        assert nb * 4 * h * w * c <= INT_MAX  # every offset into the 2x side is an int
        assert grid == nb * plan.tiles_h * plan.tiles_w
        assert grid * plan.slices * plan.block <= INT_MAX
    nb = min(n, 2)  # later images only add to the image index
    nn, i0, j, g = kernel_threads(plan, nb, h, w, groups)
    key = ((nn * h + i0) * w + j) * groups + g
    assert np.unique(key).size == key.size == nb * row_blocks * w * groups
    assert nn.min() == 0 and nn.max() == nb - 1
    one = (nn == 0) & (g == 0)
    per = 2 if direction == "fwd" else 1  # outputs a thread writes per input pixel, per axis
    count = np.zeros((h * per, w * per), np.int64)
    for s in range(plan.rows):
        i = i0[one] + s
        ok = i < h
        for dy in range(per):
            for dx in range(per):
                np.add.at(count, (per * i[ok] + dy, per * j[one][ok] + dx), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("batch", [1, 2, 8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_plan_covers_every_output_once_at_decoder_shapes(direction, dtype, batch):
    """(c) At the 7 decoder shapes and each batch the paths use."""
    for h, c in DECODER_SHAPES:
        check_plan(direction, batch, h, h, c, dtype)


@pytest.mark.parametrize("n,h,w,c", [(1, 1, 1, 8), (3, 2, 3, 8), (2, 5, 7, 16), (1, 3, 16, 8),
                                     (5, 9, 33, 24), (1, 3, 5, 2048), (2, 9, 4, 2200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_plan_covers_every_output_once_at_odd_shapes(direction, dtype, n, h, w, c):
    """Odd sizes, and channels beyond a block's 256 groups (2048 fp32 is
    512 groups, 2 slices; 2200 is 550 fp32 or 275 bf16 groups, slices
    of 184 and 138 with the last one short)."""
    check_plan(direction, n, h, w, c, dtype)


def test_plan_splits_a_batch_beyond_int_range_and_raises_beyond_one_image():
    """(c) Batch 128 of the 256^2 x 64 decoder input passes 2^31 elements
    on its 2x side: the plan splits it into launches that each fit; an
    image whose 2x side alone passes it raises, as do shapes the kernels
    do not take."""
    per_image = 4 * 256 * 256 * 64
    for direction in ("fwd", "bwd"):
        plan = plan_upsample(direction, 128, 256, 256, 64, torch.float32)
        assert len(plan.chunks) == 2 and 128 * per_image > INT_MAX
        assert all(nb * per_image <= INT_MAX for _, nb, _ in plan.chunks)
        check_plan(direction, 128, 256, 256, 64, torch.float32)
        assert len(plan_upsample(direction, 32, 256, 256, 64, torch.float32).chunks) == 1
    with pytest.raises(ValueError, match="32-bit"):
        plan_upsample("fwd", 1, 16384, 16384, 4, torch.float32)
    with pytest.raises(ValueError, match="C % 8"):
        plan_upsample("bwd", 1, 4, 4, 12, torch.bfloat16)
    with pytest.raises(ValueError, match="direction"):
        plan_upsample("up", 1, 4, 4, 8, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        plan_upsample("fwd", 1, 4, 4, 8, torch.float16)


def test_plan_is_cached_and_picks_from_the_shape():
    """One plan a shape; the forward takes one pixel a thread in tiles 4
    rows high, the adjoint 2 dx rows a thread (1 where dx is at most
    8 x 8) in tiles 2 row blocks high."""
    a = plan_upsample("fwd", 8, 256, 256, 64, torch.float32)
    assert plan_upsample("fwd", 8, 256, 256, 64, torch.float32) is a
    assert (a.rows, a.gb, a.rt, a.ht, a.block) == (1, 16, 4, 4, 256)
    for (direction, h, c, dtype), want in [(("bwd", 128, 128, torch.float32), (2, 2)),
                                           (("bwd", 128, 128, torch.bfloat16), (2, 2)),
                                           (("bwd", 8, 512, torch.float32), (1, 2)),
                                           (("fwd", 128, 128, torch.float32), (1, 4)),
                                           (("fwd", 4, 512, torch.float32), (1, 2))]:
        p = plan_upsample(direction, 8, h, h, c, dtype)
        assert (p.rows, p.ht) == want, (direction, h, c, dtype)


@pytest.mark.parametrize("shape", [(1, 5, 7, 8), (2, 3, 9, 4), (1, 2, 2, 512), (1, 7, 5, 4),
                                   (2, 2, 6, 512)])
def test_forward_plain_matches_pallas_at_odd_sizes(shape):
    """(d) The plain forward against the Pallas kernel in interpret mode at
    odd H and W, H = 2 and C = 512."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    got = upsample2x_fwd_plain(torch.from_numpy(x)).numpy()
    want = np.asarray(upsample2x_fwd_pallas(jnp.asarray(x), interpret=True))
    assert got.shape == want.shape and max_rel(got, want) <= REL_TOL


@pytest.mark.parametrize("shape", [(1, 3, 5, 8), (2, 2, 3, 4), (1, 2, 2, 512), (1, 1, 7, 4),
                                   (2, 2, 9, 512)])
def test_backward_plain_matches_pallas_at_odd_sizes(shape):
    """(d) The plain adjoint against the Pallas adjoint in interpret mode at
    odd W, H = 2 (and 1, 3: its row blocks of min(4, H) must divide H) and
    C = 512."""
    n, h, w, c = shape
    g = np.random.default_rng(sum(shape) + 7).standard_normal((n, 2 * h, 2 * w, c)).astype(np.float32)
    got = upsample2x_bwd_plain(torch.from_numpy(g)).numpy()
    want = np.asarray(upsample2x_bwd_pallas(jnp.asarray(g), interpret=True))
    assert got.shape == want.shape == shape and max_rel(got, want) <= REL_TOL
