"""P1-P5: the Mosaic probes as CUDA kernels, and their plain versions.

Replace scripts/probe_mosaic.py :: probe_lane_reduce (P1),
probe_matvec_dot (P2), probe_lane_concat_dot (P3), probe_mask_broadcast
(P4) and probe_row_build (P5). Each computes the function its TPU probe
computed, over a [..., C] fp32 tensor whose leading dimensions are
flattened; the kernels are ``csrc/probes.cu`` (fp32 SIMT, launch-bound at
the probes' 256 KiB; the source note there gives each design).
``empty_launch`` launches an empty kernel: the floor under their times.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises, and counts the launch in
its ``.launches``. None records a gradient.
"""

from __future__ import annotations

import torch

from ._build import check, load_library

_INT_MAX = 2**31 - 1


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


def _launch(wrapper, out: torch.Tensor, *args) -> torch.Tensor:
    """Launch ``wrapper``'s kernel (C symbol ``tg_<name>``) on the current
    stream, raise on a launch error, and count the launch."""
    entry = wrapper.__name__
    lib = load_library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(getattr(lib, f"tg_{entry}")(*args, stream), entry)
    wrapper.launches += 1
    return out


def _need(cond: bool, entry: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{entry}: {msg}")


def probe_lane_reduce(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """P1: a [..., C], k [C] -> sum over C of a * k, [...]."""
    if not _on_card("probe_lane_reduce", a, k):
        return probe_lane_reduce_plain(a, k)
    c = a.shape[-1]
    _need(a.dim() >= 1 and a.numel() > 0 and tuple(k.shape) == (c,), "probe_lane_reduce",
          f"a {tuple(a.shape)} and k {tuple(k.shape)}: needs k [C] with C = a's last dim")
    out = torch.empty(a.shape[:-1], dtype=torch.float32, device=a.device)
    return _launch(probe_lane_reduce, out, a.data_ptr(), k.data_ptr(), out.data_ptr(),
                   a.numel() // c, c)


def probe_matvec_dot(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """P2: a [..., C], k [C, 1] -> a @ k with the N = 1 dim dropped, [...]."""
    if not _on_card("probe_matvec_dot", a, k):
        return probe_matvec_dot_plain(a, k)
    c = a.shape[-1]
    _need(a.dim() >= 1 and a.numel() > 0 and tuple(k.shape) == (c, 1) and c <= 12288,
          "probe_matvec_dot",
          f"a {tuple(a.shape)} and k {tuple(k.shape)}: needs k [C, 1], C <= 12288")
    out = torch.empty(a.shape[:-1], dtype=torch.float32, device=a.device)
    return _launch(probe_matvec_dot, out, a.data_ptr(), k.data_ptr(), out.data_ptr(),
                   a.numel() // c, c)


def probe_lane_concat_dot(a: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """P3: a [..., C], k2 [2C, N] -> concat([a, 2a], -1) @ k2, [..., N]."""
    if not _on_card("probe_lane_concat_dot", a, k2):
        return probe_lane_concat_dot_plain(a, k2)
    c = a.shape[-1]
    _need(a.dim() >= 1 and a.numel() > 0 and k2.dim() == 2 and k2.shape[0] == 2 * c
          and k2.shape[1] > 0, "probe_lane_concat_dot",
          f"a {tuple(a.shape)} and k2 {tuple(k2.shape)}: needs k2 [2C, N]")
    m, n = a.numel() // c, k2.shape[1]
    _need(m * n <= _INT_MAX and (m + 31) // 32 <= 65535, "probe_lane_concat_dot",
          f"{m} rows x {n} columns: above the kernel's grid")
    out = torch.empty((*a.shape[:-1], n), dtype=torch.float32, device=a.device)
    return _launch(probe_lane_concat_dot, out, a.data_ptr(), k2.data_ptr(), out.data_ptr(),
                   m, c, n)


def probe_mask_broadcast(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """P4: a [..., C], m [...] -> a * m[..., None]."""
    if not _on_card("probe_mask_broadcast", a, m):
        return probe_mask_broadcast_plain(a, m)
    c = a.shape[-1]
    _need(a.dim() >= 1 and a.numel() > 0 and tuple(m.shape) == tuple(a.shape[:-1]),
          "probe_mask_broadcast", f"a {tuple(a.shape)} and m {tuple(m.shape)}: needs m [...]")
    out = torch.empty_like(a)
    return _launch(probe_mask_broadcast, out, a.data_ptr(), m.data_ptr(), out.data_ptr(),
                   a.numel() // c, c)


def probe_row_build(a: torch.Tensor) -> torch.Tensor:
    """P5: rows along dim 0, .25 * a[r] + .75 * a[r + 1], the last row copied."""
    if not _on_card("probe_row_build", a):
        return probe_row_build_plain(a)
    _need(a.dim() >= 1 and a.numel() > 0, "probe_row_build", f"empty input {tuple(a.shape)}")
    out = torch.empty_like(a)
    rows = a.shape[0]
    return _launch(probe_row_build, out, a.data_ptr(), out.data_ptr(), rows, a.numel() // rows)


PROBES = (probe_lane_reduce, probe_matvec_dot, probe_lane_concat_dot, probe_mask_broadcast,
          probe_row_build)
for _probe in PROBES:
    _probe.launches = 0
# each wrapper's plain version, which a card's results are held against
PLAIN = {probe_lane_reduce: probe_lane_reduce_plain, probe_matvec_dot: probe_matvec_dot_plain,
         probe_lane_concat_dot: probe_lane_concat_dot_plain,
         probe_mask_broadcast: probe_mask_broadcast_plain, probe_row_build: probe_row_build_plain}


def empty_launch(device) -> None:
    """One empty kernel on ``device``'s current stream (counted nowhere)."""
    lib = load_library()
    with torch.cuda.device(device):
        check(lib.tg_probe_empty(torch.cuda.current_stream().cuda_stream), "probe_empty")
