"""Run the five probe kernels (csrc/probes.cu) once and check them against numpy.

    python -m terra_gan_tpu_torch.cli.probe_cuda [--device cuda|cpu]

The counterpart of scripts/probe_mosaic.py: the same inputs (numpy's
``default_rng(0)``, drawn in the same order: A [16, 64, 64], K1 [64],
K2 [64, 64], M [16, 64], fp32), the same five probes and the same numpy
expressions, one line each, ``name: OK maxerr=...`` or ``name: FAIL ...``.
A probe fails when it raises (a build or launch error included) or when
it is off numpy by more than its tolerance: 1e-6 of the largest expected
value for the three sums, which run in another order, and nothing for
the broadcast and the row build, which round as numpy does. Unlike the
JAX script it exits 1 if any probe fails. On ``--device cpu`` the
wrappers run their plain versions.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..ops.cuda.probe_kernels import (
    probe_lane_concat_dot,
    probe_lane_reduce,
    probe_mask_broadcast,
    probe_matvec_dot,
    probe_row_build,
)
from ..utils.device import resolve_device

ROWS, COLS, C = 16, 64, 64
SUM_TOL = 1e-6  # of max|expected|: fp32 sums in another order than numpy's


@dataclass
class ProbeResult:
    label: str
    name: str
    ok: bool
    maxerr: float
    message: str = ""

    def line(self) -> str:
        if self.ok:
            return f"{self.label}: OK maxerr={self.maxerr:.2e}"
        return f"{self.label}: FAIL {self.message}"


def probe_inputs():
    """A, K1, K2, M as scripts/probe_mosaic.py draws them."""
    rng = np.random.default_rng(0)
    a = rng.random((ROWS, COLS, C), np.float32).astype(np.float32)
    k1 = rng.random((C,), np.float32)
    k2 = rng.random((C, C), np.float32)
    m = rng.random((ROWS, COLS), np.float32)
    return a, k1, k2, m


def probe_cases(a, k1, k2, m):
    """(label, wrapper, numpy inputs, numpy expectation, tolerance of max|expected|)."""
    k2x2 = np.concatenate([k2, k2]).astype(np.float32)
    return [
        ("lane_reduce (sum over C -> [rows,cols])", probe_lane_reduce, (a, k1),
         (a * k1).sum(-1), SUM_TOL),
        ("matvec_dot  (dot K=C N=1 -> [rows,cols])", probe_matvec_dot, (a, k1.reshape(C, 1)),
         a @ k1, SUM_TOL),
        ("lane_concat_dot (K=2C packed dot)", probe_lane_concat_dot, (a, k2x2),
         np.concatenate([a, a * 2.0], -1) @ k2x2, SUM_TOL),
        ("mask_broadcast ([rows,cols] -> C lanes)", probe_mask_broadcast, (a, m),
         a * m[..., None], 0.0),
        ("row_build (static row-slice writes)", probe_row_build, (a,),
         np.concatenate([0.25 * a[:-1] + 0.75 * a[1:], a[-1:]], 0), 0.0),
    ]


def run_probes(device="cuda") -> List[ProbeResult]:
    """Each probe once on ``device`` against its numpy expectation."""
    dev = resolve_device(device)
    results = []
    for label, fn, args, want, tol in probe_cases(*probe_inputs()):
        try:
            got = fn(*(torch.from_numpy(x).to(dev) for x in args))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # a fault in the kernel surfaces here
            got = got.cpu().numpy()
            if got.shape != want.shape:
                raise ValueError(f"shape {got.shape}, expected {want.shape}")
            err = float(np.abs(got - want).max())
            limit = tol * float(np.abs(want).max())
            ok = err <= limit
            msg = "" if ok else f"maxerr={err:.2e} above {limit:.2e}"
            results.append(ProbeResult(label, fn.__name__, ok, err, msg))
        except Exception as e:  # noqa: BLE001 - each probe reports its own failure
            msg = str(e).splitlines()[0][:160] if str(e) else type(e).__name__
            results.append(ProbeResult(label, fn.__name__, False, float("nan"), msg))
            if os.environ.get("PROBE_VERBOSE"):
                traceback.print_exc()
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    results = run_probes(args.device)
    for r in results:
        print(r.line(), flush=True)
    return 0 if all(r.ok for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
