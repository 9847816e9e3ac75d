"""The numbers that decide ``correct``: each compares what the timed path
produced with the plain reference (torch_bench/reference)."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional

import torch


def nrmse(got: torch.Tensor, want: torch.Tensor) -> float:
    """RMS of the difference over the RMS of the reference (inf where the
    shapes differ)."""
    if got.shape != want.shape:
        return float("inf")
    got, want = got.double(), want.double()
    den = want.square().mean().sqrt()
    return float((got - want).square().mean().sqrt() / den) if den > 0 else float("inf")


def mismatch_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of elements that differ."""
    if got.shape != want.shape:
        return 1.0
    return float((got != want).double().mean())


def loss_gap(got: Iterable[float], want: Iterable[float]) -> float:
    """Worst |got - want| / |want| over paired losses."""
    gaps = [abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want, strict=True)]
    return worst(gaps)


def worst(values) -> float:
    """The largest value; inf if there is none or any is not finite."""
    values = list(values)
    if not values or not all(math.isfinite(v) for v in values):
        return float("inf")
    return max(values)


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Per leaf: |norm got - norm want| over the larger of the reference's
    norm of that leaf and of the median leaf (a leaf the program lacks
    reads nan)."""
    keys = list(want if keep is None else keep)
    if not keys:
        return {}
    median = statistics.median(want[k] for k in keys)
    return {k: abs(got.get(k, float("nan")) - want[k]) / max(want[k], median, 1e-30)
            for k in keys}


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap (``leaf_gaps``); inf if any is not finite."""
    return worst(leaf_gaps(got, want, keep).values())


def moving_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's: the rest move under Adam by round-off alone."""
    median = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v > 1e-3 * median]
