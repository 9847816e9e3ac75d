"""P1-P5: the Mosaic probes as CUDA kernels, and their plain versions.

Replace scripts/probe_mosaic.py :: probe_lane_reduce (P1),
probe_matvec_dot (P2), probe_lane_concat_dot (P3), probe_mask_broadcast
(P4) and probe_row_build (P5). Each computes the function its TPU probe
computed, over a [..., C] fp32 tensor whose leading dimensions are
flattened; the kernels are ``csrc/probes.cu`` (fp32 SIMT, launch-bound at
the probes' 256 KiB; the source note there gives each design).
``empty_launch`` launches an empty kernel: the floor under their times.

P1 runs P2's kernel (L lanes a row, float4 loads, an xor-shuffle tree):
its k [C] is the memory of P2's k [C, 1]. P3 takes R rows by BN columns a
block (those that copy the fewest bytes into the busiest SM), stages the
rows of a and the two halves of k2 those columns need in shared memory
in one load round (K in chunks, double-buffered, where a stage passes 48
KB), builds the 2a half from the a in registers, and sums each output as
lo (the a half, one group of threads) + hi (the 2a half, another).

Each has two variants, ``vec4`` (16-byte loads; C % 4 == 0 and 16-byte
aligned inputs, for P3 also N % 4 == 0, for P5 a row of a multiple of 4
floats) and ``scalar`` (any C, N and alignment); ``plan_probe`` picks
the variant, the grid and the block (and P3's rows a block and K chunk)
from the tensors alone, and a wrapper's ``variant=`` forces one. Their
``.variants`` count the launches by variant. P5 takes a float4 (or a
float) a thread, no loop.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises, and counts the launch in
its ``.launches``. None records a gradient.
"""

from __future__ import annotations

import torch

from ._build import check, load_library

_INT_MAX = 2**31 - 1
# the probes' variants, numbered as the C entry points take them
VARIANTS = ("scalar", "vec4")
PROBE_THREADS = 128  # P1's, P2's and P4's block
ROW_BUILD_THREADS = 256  # P5's block
# the SMs of an H100; the most blocks P1, P2 and P4 launch: 16 of 128
# threads fill an SM's 2048 threads (a grid-stride loop takes the rest)
SM_COUNT = 132
MAX_PROBE_BLOCKS = SM_COUNT * 16
# P3's tiles: R rows of CONCAT_ROWS by 4 * BQ columns, BQ a power of two up
# to CONCAT_MAX_QUADS, a thread of each of two groups (the a half and the
# 2a half) a row and a column quad, at most CONCAT_THREADS a block; a
# block's shared memory (one stage, or two where K goes in chunks, and the
# hand-over between the groups) stays within the 48 KB a launch takes
# without opting in; at most 16 rows, so that a warp's float4 loads of a
# span at most 256 bytes
CONCAT_ROWS = (16, 8, 4, 2, 1)
CONCAT_MAX_QUADS = 16
CONCAT_THREADS = 256
CONCAT_SMEM_BUDGET = 48 * 1024


def probe_lane_reduce_plain(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[..., C] * k[C] summed over C -> [...]."""
    return (a * k).sum(-1)


def probe_matvec_dot_plain(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The contraction of [..., C] with k [C, 1] -> [...] (the dot's N = 1 dropped)."""
    return (a * k[:, 0]).sum(-1)


def probe_lane_concat_dot_plain(a: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """concat([a, 2a], -1) @ k2: [..., C] and [2C, N] -> [..., N]."""
    return torch.cat([a, a * 2.0], -1) @ k2


def probe_mask_broadcast_plain(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[..., C] times the field m [...] broadcast over C."""
    return a * m[..., None]


def probe_row_build_plain(a: torch.Tensor) -> torch.Tensor:
    """Rows along dim 0: .25 * a[r] + .75 * a[r + 1], the last row copied."""
    return torch.cat([0.25 * a[:-1] + 0.75 * a[1:], a[-1:]], 0)


def _on_card(entry: str, *tensors: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA tensors
    the kernel takes; raises on anything else."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{entry}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{entry}: needs contiguous float32 tensors on {dev}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
        if t.numel() > _INT_MAX:
            raise ValueError(f"{entry}: {t.numel()} elements, above the kernel's int range")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{entry}: the kernel records no gradient")
    return True


def _launch(wrapper, out: torch.Tensor, *args, variant=None) -> torch.Tensor:
    """Launch ``wrapper``'s kernel (C symbol ``tg_<name>``) on the current
    stream, raise on a launch error, and count the launch (and its variant)."""
    entry = wrapper.__name__
    lib = load_library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(getattr(lib, f"tg_{entry}")(*args, stream), entry)
    wrapper.launches += 1
    if variant is not None:
        wrapper.variants[variant] += 1
    return out


def matvec_lanes(c: int) -> int:
    """The lanes a P1 or P2 row takes: the least power of two L <= 32 with 4L >= C."""
    lanes = 1
    while lanes < 32 and 4 * lanes < c:
        lanes *= 2
    return lanes


def concat_a_stride(kcp: int) -> int:
    """P3's a tile row stride in floats: kcp rounded up to 4 mod 32 (the
    kernel's concat_a_stride)."""
    return kcp + ((4 - kcp) & 31)


def concat_smem_bytes(rows: int, bq: int, kcp: int, stages: int) -> int:
    """A P3 block's shared memory (the kernel's concat_smem_bytes): its
    stages, each the a tile [rows][stride] and k2's two halves [kcp][4 bq],
    then a float4 for each output, which the 2a group hands over."""
    return 4 * (stages * (rows * concat_a_stride(kcp) + 2 * kcp * 4 * bq) + 4 * rows * bq)


def concat_busiest_sm_bytes(m: int, c: int, n: int, rows: int, bq: int) -> int:
    """The bytes P3's tiles of ``rows`` rows by 4 * ``bq`` columns copy into
    the shared memory of the busiest SM, a tile a block: its rows of a and
    k2's 2C rows at its columns, times the tiles that SM takes (one where
    they do not outnumber the SMs)."""
    tiles = -(-m // rows) * -(-n // (4 * bq))
    return -(-tiles // SM_COUNT) * 4 * (rows * c + 2 * c * 4 * bq)


def _concat_tiling(m: int, c: int, n: int):
    """(rows, quads, kchunk, tiles) of P3 at a [m, c] and k2 [2c, n]."""
    bq_max = 1  # the least power of two with 4 BQ >= N, at most CONCAT_MAX_QUADS
    while bq_max < CONCAT_MAX_QUADS and 4 * bq_max < n:
        bq_max *= 2
    # every block copies its rows of a and its columns of k2, and where the
    # blocks are many and small those copies are what costs (profile_slice.py's
    # P3 sweep): the fewest bytes on the busiest SM, then the fewest blocks
    shapes = [(r, q) for r in CONCAT_ROWS for q in (1, 2, 4, 8, 16)
              if q <= bq_max and 2 * r * q <= CONCAT_THREADS]
    rows, bq = min(shapes, key=lambda s: (concat_busiest_sm_bytes(m, c, n, *s),
                                          -(-m // s[0]) * -(-n // (4 * s[1]))))
    kchunk = c
    if concat_smem_bytes(rows, bq, -(-c // 4) * 4, 1) > CONCAT_SMEM_BUDGET:
        # two stages: from a chunk that fits whatever the stride's padding, up
        room = CONCAT_SMEM_BUDGET - concat_smem_bytes(rows, bq, 0, 0) - 2 * 4 * 31 * rows
        kchunk = max(4, room // (2 * 4 * (rows + 8 * bq)) // 4 * 4)
        while kchunk + 4 < c and concat_smem_bytes(rows, bq, kchunk + 4, 2) <= CONCAT_SMEM_BUDGET:
            kchunk += 4
    return rows, bq, kchunk, -(-m // rows) * -(-n // (4 * bq))


def plan_probe(name: str, a: torch.Tensor, *others: torch.Tensor, variant=None):
    """The launch of P1 (``probe_lane_reduce``, others = (k,)), P2
    (``probe_matvec_dot``, others = (k,)), P3 (``probe_lane_concat_dot``,
    others = (k2,)), P4 (``probe_mask_broadcast``, others = (m,)) or P5
    (``probe_row_build``, no others) for these tensors: (variant, grid,
    block), and for P3 (variant, grid, block, rows, kchunk).

    ``vec4`` where C % 4 == 0 (for P3 also N % 4 == 0; for P5 the row
    along dim 0, ``a[0].numel()``, instead of C) and the float4-read
    inputs (a, and P1's and P2's k or P3's k2) start on 16 bytes, else
    ``scalar``; ``variant`` forces one, and vec4 raises where it cannot
    run. P1, P2 and P4: the grid covers every row in one pass up to
    MAX_PROBE_BLOCKS blocks (the kernels loop over the rest); P1 and P2
    put PROBE_THREADS / L rows in a block, P4 a float4 (vec4) or an element
    (scalar) in a thread. P5: a float4 (vec4) or an element (scalar) a
    thread, ROW_BUILD_THREADS a block, every one in one pass. P3: one
    block a tile of ``rows`` rows by 4 * BQ columns (block = 2 * rows *
    BQ threads), the R and BQ whose tiles copy the fewest bytes into the
    busiest SM (``concat_busiest_sm_bytes``), the grid every tile once;
    ``kchunk`` = C where one stage fits
    CONCAT_SMEM_BUDGET, else the most columns of a (a multiple of 4) whose
    two stages fit. Raises above the kernels' 32-bit indices.
    """
    if name not in ("probe_lane_reduce", "probe_matvec_dot", "probe_lane_concat_dot",
                    "probe_mask_broadcast", "probe_row_build"):
        raise ValueError(f"plan_probe: no plan for {name}")
    if a.dim() < 1 or a.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(a.shape)}")
    # P5's float4s run along a row of dim 0, the others' along the last dim
    c = a.numel() // a.shape[0] if name == "probe_row_build" else a.shape[-1]
    n = a.numel() // c
    cols = others[0].shape[-1] if name == "probe_lane_concat_dot" else 1
    for what, size in (("elements", a.numel()), ("outputs", n * cols),
                       ("k2 elements", 2 * c * cols)):
        if size > _INT_MAX:
            raise ValueError(f"{name}: {size} {what}, above the kernel's int range")
    read4 = (a,) if name == "probe_mask_broadcast" else (a, *others)
    widths = (c, cols) if name == "probe_lane_concat_dot" else (c,)  # float4 rows
    vec4_ok = all(w % 4 == 0 for w in widths) and all(t.data_ptr() % 16 == 0 for t in read4)
    if variant is None:
        variant = "vec4" if vec4_ok else "scalar"
    elif variant not in VARIANTS:
        raise ValueError(f"{name}: variant {variant!r}, not one of {VARIANTS}")
    elif variant == "vec4" and not vec4_ok:
        raise ValueError(f"{name}: vec4 needs C % 4 == 0 (P3: and N % 4 == 0) and 16-byte "
                         f"aligned inputs (C = {c}, N = {cols}, offsets "
                         f"{[t.data_ptr() % 16 for t in read4]})")
    if name == "probe_lane_concat_dot":
        rows, bq, kchunk, tiles = _concat_tiling(n, c, cols)
        return variant, tiles, 2 * rows * bq, rows, kchunk
    if name == "probe_row_build":
        items = a.numel() // 4 if variant == "vec4" else a.numel()
        return variant, -(-items // ROW_BUILD_THREADS), ROW_BUILD_THREADS
    if name == "probe_mask_broadcast":
        per_block = PROBE_THREADS  # float4s or elements
        items = n * c // 4 if variant == "vec4" else n * c
    else:
        per_block = PROBE_THREADS // matvec_lanes(c)  # rows
        items = n
    grid = min(-(-items // per_block), MAX_PROBE_BLOCKS)
    return variant, grid, PROBE_THREADS


def _need(cond: bool, entry: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{entry}: {msg}")


def probe_lane_reduce(a: torch.Tensor, k: torch.Tensor, variant=None) -> torch.Tensor:
    """P1: a [..., C], k [C] -> sum over C of a * k, [...]; ``variant``
    forces plan_probe's choice."""
    if not _on_card("probe_lane_reduce", a, k):
        return probe_lane_reduce_plain(a, k)
    c = a.shape[-1]
    _need(a.dim() >= 1 and a.numel() > 0 and tuple(k.shape) == (c,), "probe_lane_reduce",
          f"a {tuple(a.shape)} and k {tuple(k.shape)}: needs k [C] with C = a's last dim")
    variant, grid, block = plan_probe("probe_lane_reduce", a, k, variant=variant)
    out = torch.empty(a.shape[:-1], dtype=torch.float32, device=a.device)
    return _launch(probe_lane_reduce, out, a.data_ptr(), k.data_ptr(), out.data_ptr(),
                   a.numel() // c, c, VARIANTS.index(variant), grid, block, variant=variant)


def probe_matvec_dot(a: torch.Tensor, k: torch.Tensor, variant=None) -> torch.Tensor:
    """P2: a [..., C], k [C, 1] -> a @ k with the N = 1 dim dropped, [...];
    ``variant`` forces plan_probe's choice."""
    if not _on_card("probe_matvec_dot", a, k):
        return probe_matvec_dot_plain(a, k)
    c = a.shape[-1]
    _need(a.dim() >= 1 and a.numel() > 0 and tuple(k.shape) == (c, 1), "probe_matvec_dot",
          f"a {tuple(a.shape)} and k {tuple(k.shape)}: needs k [C, 1]")
    variant, grid, block = plan_probe("probe_matvec_dot", a, k, variant=variant)
    out = torch.empty(a.shape[:-1], dtype=torch.float32, device=a.device)
    return _launch(probe_matvec_dot, out, a.data_ptr(), k.data_ptr(), out.data_ptr(),
                   a.numel() // c, c, VARIANTS.index(variant), grid, block, variant=variant)


def probe_lane_concat_dot(a: torch.Tensor, k2: torch.Tensor, variant=None) -> torch.Tensor:
    """P3: a [..., C], k2 [2C, N] -> concat([a, 2a], -1) @ k2, [..., N];
    ``variant`` forces plan_probe's choice."""
    if not _on_card("probe_lane_concat_dot", a, k2):
        return probe_lane_concat_dot_plain(a, k2)
    c = a.shape[-1]
    _need(a.dim() >= 1 and a.numel() > 0 and k2.dim() == 2 and k2.shape[0] == 2 * c
          and k2.shape[1] > 0, "probe_lane_concat_dot",
          f"a {tuple(a.shape)} and k2 {tuple(k2.shape)}: needs k2 [2C, N]")
    variant, grid, block, rows, kchunk = plan_probe("probe_lane_concat_dot", a, k2,
                                                    variant=variant)
    n = k2.shape[1]
    out = torch.empty((*a.shape[:-1], n), dtype=torch.float32, device=a.device)
    return _launch(probe_lane_concat_dot, out, a.data_ptr(), k2.data_ptr(), out.data_ptr(),
                   a.numel() // c, c, n, VARIANTS.index(variant), grid, block, rows, kchunk,
                   variant=variant)


def probe_mask_broadcast(a: torch.Tensor, m: torch.Tensor, variant=None) -> torch.Tensor:
    """P4: a [..., C], m [...] -> a * m[..., None]; ``variant`` forces
    plan_probe's choice."""
    if not _on_card("probe_mask_broadcast", a, m):
        return probe_mask_broadcast_plain(a, m)
    c = a.shape[-1]
    _need(a.dim() >= 1 and a.numel() > 0 and tuple(m.shape) == tuple(a.shape[:-1]),
          "probe_mask_broadcast", f"a {tuple(a.shape)} and m {tuple(m.shape)}: needs m [...]")
    variant, grid, block = plan_probe("probe_mask_broadcast", a, m, variant=variant)
    out = torch.empty_like(a)  # a fresh allocation: 16-byte aligned
    return _launch(probe_mask_broadcast, out, a.data_ptr(), m.data_ptr(), out.data_ptr(),
                   a.numel() // c, c, VARIANTS.index(variant), grid, block, variant=variant)


def probe_row_build(a: torch.Tensor, variant=None) -> torch.Tensor:
    """P5: rows along dim 0, .25 * a[r] + .75 * a[r + 1], the last row
    copied; ``variant`` forces plan_probe's choice."""
    if not _on_card("probe_row_build", a):
        return probe_row_build_plain(a)
    _need(a.dim() >= 1 and a.numel() > 0, "probe_row_build", f"empty input {tuple(a.shape)}")
    variant, grid, block = plan_probe("probe_row_build", a, variant=variant)
    out = torch.empty_like(a)  # a fresh allocation: 16-byte aligned
    rows = a.shape[0]
    return _launch(probe_row_build, out, a.data_ptr(), out.data_ptr(), rows, a.numel() // rows,
                   VARIANTS.index(variant), grid, block, variant=variant)


PROBES = (probe_lane_reduce, probe_matvec_dot, probe_lane_concat_dot, probe_mask_broadcast,
          probe_row_build)
for _probe in PROBES:
    _probe.launches = 0
    _probe.variants = dict.fromkeys(VARIANTS, 0)
# each wrapper's plain version, which a card's results are held against
PLAIN = {probe_lane_reduce: probe_lane_reduce_plain, probe_matvec_dot: probe_matvec_dot_plain,
         probe_lane_concat_dot: probe_lane_concat_dot_plain,
         probe_mask_broadcast: probe_mask_broadcast_plain, probe_row_build: probe_row_build_plain}


def empty_launch(device) -> None:
    """One empty kernel on ``device``'s current stream (counted nowhere)."""
    lib = load_library()
    with torch.cuda.device(device):
        check(lib.tg_probe_empty(torch.cuda.current_stream().cuda_stream), "probe_empty")
