"""Environment and install diagnostics for the port (counterpart of terra_gan_tpu/cli/doctor.py).

    python -m terra_gan_tpu_torch.cli.doctor [--cpu] [--config PATH]
    python -m terra_gan_tpu_torch.cli.doctor --inspect CKPT

Runs the port's load-bearing paths in seconds and reports
PASS/WARN/FAIL/SKIP per check, before a job is scheduled:

  * versions      — python / torch / CUDA runtime / numpy / nvcc / triton
  * backend       — the card: name, compute capability, count, TF32 state;
                    FAIL without CUDA unless ``--cpu`` was given, which
                    checks the CPU path and SKIPs the kernel rows
  * kernel-build  — csrc/*.cu built for sm_90a (or the cached build):
                    seconds, and ptxas's registers and spills
  * native        — SKIP: not ported yet
  * model         — a base_width=8 PConvUNet on a masked 32x32 tile gives
                    finite values; on the card through 13 K2, 6 K1 fwd
                    and 1 K3 launches, within NRMSE 1e-5 of its plain path
  * probes        — the five probe kernels against numpy (cli/probe_cuda.py)
  * quant, mesh   — SKIP: not ported yet
  * config        — the config file loads through the typed schema
  * checkpoint    — ``--inspect ckpt.pth``: layout, epoch, parameter
                    count, VGG-weight provenance tag, as JSON

Exit code: 0 when nothing FAILs (WARNs and SKIPs allowed), 1 otherwise.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Callable, List, Optional, Tuple

PASS, WARN, FAIL, SKIP = "PASS", "WARN", "FAIL", "SKIP"
MODEL_NRMSE_TOL = 1e-5  # the model row: kernel path against the plain path, fp32, TF32 off


class _Report:
    def __init__(self) -> None:
        self.rows: List[Tuple[str, str, str]] = []

    def add(self, name: str, status: str, detail: str = "") -> None:
        self.rows.append((name, status, detail))
        print(f"  [{status:4s}] {name}" + (f" — {detail}" if detail else ""))

    def run(self, name: str, fn: Callable[[], Optional[str]]) -> None:
        """fn returns a detail string (PASS) or raises; a returned
        string starting with 'WARN:' downgrades to WARN, 'SKIP:' to SKIP."""
        try:
            detail = fn() or ""
            for status in (WARN, SKIP):
                if detail.startswith(f"{status}:"):
                    self.add(name, status, detail[len(status) + 1:].strip())
                    return
            self.add(name, PASS, detail)
        except Exception as e:  # noqa: BLE001 - each check is a probe
            self.add(name, FAIL, f"{type(e).__name__}: {e}")

    @property
    def failed(self) -> bool:
        return any(s == FAIL for _, s, _ in self.rows)


def _nvcc_version() -> str:
    from ..ops.cuda._build import find_nvcc

    try:
        nvcc = find_nvcc()
    except RuntimeError:
        return "absent"
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    found = re.search(r"release ([\d.]+)", out)
    return found.group(1) if found else out.strip().splitlines()[-1]


def _check_versions() -> str:
    import numpy as np
    import torch

    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    return (
        f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA runtime {torch.version.cuda or 'none (CPU build)'}, numpy {np.__version__}, "
        f"nvcc {_nvcc_version()}, triton {triton_version}"
    )


def _check_backend(cpu: bool) -> str:
    import torch

    if cpu:
        return f"cpu requested: torch on the CPU, {torch.get_num_threads()} threads"
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (pass --cpu to check the CPU path)")
    major, minor = torch.cuda.get_device_capability(0)
    detail = (
        f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}, sm_{major}{minor}; "
        f"TF32 cudnn={torch.backends.cudnn.allow_tf32} "
        f"matmul={torch.backends.cuda.matmul.allow_tf32}"
    )
    if (major, minor) != (9, 0):
        return f"WARN: {detail}; the kernels are built for sm_90a only"
    return detail


def _check_kernel_build(cpu: bool) -> str:
    from ..ops.cuda._build import build_info, load_library

    if cpu:
        return "SKIP: cpu requested"
    load_library()
    info = build_info()
    log = str(info["log"])
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(a) + int(b) for a, b in
                 re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
    report = (f"{len(regs)} kernels, registers up to {max(regs)}, {spills} bytes spilled"
              if regs else "no ptxas report")
    return (
        f"{len(info['sources'])} sources {'built' if info['built'] else 'cached'} for sm_90a "
        f"in {info['seconds']:.1f} s; {report}; {info['path']}"
    )


def _check_model(cpu: bool) -> str:
    import numpy as np
    import torch

    from ..ops.cuda.pconv_kernel import fused_pconv_eval
    from ..ops.cuda.tail_kernel import fused_decoder_tail
    from ..ops.cuda.upsample_kernel import upsample2x_fwd
    from ..utils.weights import init_generator

    dev = torch.device("cpu" if cpu else "cuda")
    G = init_generator(8, torch.Generator().manual_seed(0), dev)
    x = torch.from_numpy(np.linspace(0, 1, 32 * 32, dtype=np.float32)
                         .reshape(1, 32, 32, 1)).to(dev)
    m = torch.ones((1, 32, 32, 1), device=dev)
    m[:, 8:16, 8:16] = 0.0
    counters = (fused_pconv_eval, upsample2x_fwd, fused_decoder_tail)
    before = [fn.launches for fn in counters]
    with torch.inference_mode():
        out = G(x * m, m)
    launches = [fn.launches - b for fn, b in zip(counters, before)]
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("non-finite forward output")
    if cpu:
        return "forward finite on a 32x32 masked tile (cpu, plain versions)"
    if launches != [13, 6, 1]:
        raise RuntimeError(f"K2, K1 fwd, K3 launched {launches} times, want [13, 6, 1]")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = G.forward_plain(x * m, m)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    a, b = out.double(), want.double()
    err = ((a - b).pow(2).mean().sqrt() / b.abs().max().clamp_min(1e-12)).item()
    if not err <= MODEL_NRMSE_TOL:
        raise RuntimeError(f"NRMSE {err:.2e} against the plain path, above {MODEL_NRMSE_TOL}")
    return (f"forward finite on a 32x32 masked tile through {launches[0]} K2, "
            f"{launches[1]} K1 fwd, {launches[2]} K3; NRMSE {err:.1e} vs the plain path")


def _check_probes(cpu: bool) -> str:
    from .probe_cuda import run_probes

    if cpu:
        return "SKIP: cpu requested"
    results = run_probes("cuda")
    detail = "; ".join(
        f"{r.name} OK maxerr={r.maxerr:.1e}" if r.ok else f"{r.name} FAIL {r.message}"
        for r in results
    )
    if not all(r.ok for r in results):
        raise RuntimeError(detail)
    return detail


def _not_ported(what: str) -> Callable[[], str]:
    return lambda: f"SKIP: not ported yet ({what})"


def _check_config(path: Optional[str]) -> str:
    from ..config import load_config

    if path is None:
        example = Path(__file__).resolve().parents[2] / "config.example.yaml"
        if not example.exists():
            return "WARN: no --config given and no config.example.yaml found"
        path = str(example)
    cfg = load_config(path)
    t = cfg.training.initial
    return (
        f"{Path(path).name}: epochs={t.epochs} batch={t.batch_size} "
        f"lr={t.learning_rate}"
    )


def _to_numpy(obj):
    """Tensors as numpy arrays, inside dicts, lists and tuples."""
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    try:
        return obj.detach().cpu().numpy()
    except AttributeError:
        return obj


def _inspect_checkpoint(path: str) -> int:
    """Print a checkpoint's layout, provenance and parameter digest."""
    import pickle

    import numpy as np
    import torch

    p = Path(path)
    info = {"path": path, "bytes": p.stat().st_size}
    try:
        obj = _to_numpy(torch.load(p, map_location="cpu", weights_only=True))
    except pickle.UnpicklingError as e:
        info["layout"] = f"unreadable with weights_only=True ({str(e).splitlines()[0]})"
        print(json.dumps(info, indent=2))
        return 1
    if isinstance(obj, dict) and "generator_state_dict" in obj:
        info["layout"] = "reference (main_pipeline.py:386-412 contract)"
        for key in ("epoch", "g_loss", "d_loss", "human_guided",
                    "vgg_weights_provenance", "preempted",
                    "source_model"):
            if key in obj:
                info[key] = obj[key]
        sd = obj["generator_state_dict"]
        info["has_discriminator"] = "discriminator_state_dict" in obj
        info["has_optimizers"] = "optimizer_G_state_dict" in obj
    elif isinstance(obj, dict):
        info["layout"] = "raw state dict (legacy load path)"
        sd = obj
    else:
        info["layout"] = f"unrecognized ({type(obj).__name__})"
        print(json.dumps(info, indent=2))
        return 1
    n_params = n_tensors = 0
    for v in sd.values():
        n_tensors += 1
        n_params += np.asarray(v).size
    info["generator_tensors"] = n_tensors
    info["generator_parameters"] = int(n_params)
    print(json.dumps(info, indent=2, default=str))
    return 0


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="terra_gan_tpu_torch install / environment diagnostics"
    )
    p.add_argument("--cpu", action="store_true",
                   help="check the CPU path and skip the kernel rows "
                        "(without it, no CUDA is a FAIL)")
    p.add_argument("--config", default=None,
                   help="config.yaml to validate (default: the "
                        "packaged config.example.yaml if present)")
    p.add_argument("--inspect", default=None, metavar="CKPT",
                   help="inspect a .pth checkpoint instead of running "
                        "environment checks")
    args = p.parse_args(argv)

    if args.inspect:
        return _inspect_checkpoint(args.inspect)

    print("terra_gan_tpu_torch doctor")
    r = _Report()
    r.run("versions", _check_versions)
    r.run("backend", lambda: _check_backend(args.cpu))
    r.run("kernel-build", lambda: _check_kernel_build(args.cpu))
    r.run("native", _not_ported("the C++ terra_io library"))
    r.run("model", lambda: _check_model(args.cpu))
    r.run("probes", lambda: _check_probes(args.cpu))
    r.run("quant", _not_ported("int8 w8a8 evaluation"))
    r.run("mesh", _not_ported("the device mesh"))
    r.run("config", lambda: _check_config(args.config))
    counts = {s: sum(1 for _, st, _ in r.rows if st == s) for s in (PASS, WARN, FAIL, SKIP)}
    print(f"{len(r.rows)} checks: {counts[PASS]} pass, {counts[WARN]} warn, "
          f"{counts[FAIL]} fail, {counts[SKIP]} skip")
    return 1 if r.failed else 0


if __name__ == "__main__":
    sys.exit(main())
