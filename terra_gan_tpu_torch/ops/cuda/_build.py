"""Build and load the port's CUDA kernels (terra_gan_tpu_torch/csrc).

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library
with a plain C interface, loaded through ``ctypes``. The
build runs at the first CUDA call, never at import, so every module of
the port imports on a host without ``nvcc`` or a card. The library goes
under ``build/terra_gan_tpu_torch/<hash>/`` at the root of the checkout,
keyed by a hash of the sources and the flags, so an edited source builds
anew and an unchanged one is reused within the checkout.

No fast math: the PConv renormalisation divides and gates exactly as the
reference does, and K3's sigmoid takes the accurate ``expf``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "terra_gan_tpu_torch"
LIB_NAME = "libterra_gan_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, kept in build_info
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


def find_nvcc() -> str:
    """Path of nvcc from CUDA_HOME, PATH or /usr/local/cuda; raises if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin);"
        " the port's CUDA kernels are built from terra_gan_tpu_torch/csrc with it"
    )


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    deps = sorted(CSRC.glob("*.cuh")) + sorted(CSRC.glob("*.h"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs, deps


def _digest(paths) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands side by side; raise on the first that failed."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    return "".join(logs)


def _compile(nvcc: str, srcs, so: Path) -> str:
    """One nvcc per source, all at once, then one link into ``so``."""
    so.parent.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    objs = [so.with_name(f"{src.stem}.{pid}.o") for src in srcs]  # nvcc reads the suffix
    tmp = so.with_name(f"{so.name}.{pid}.tmp")
    try:
        log = _run_all(
            [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(srcs, objs)]
        )
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return log


def _bind(lib: ctypes.CDLL) -> None:
    lib.tg_pconv_eval_f32.restype = _I
    lib.tg_pconv_eval_f32.argtypes = [_P] * 9 + [_I] * 10 + [_P]
    lib.tg_pconv_eval_mma_f32.restype = _I
    lib.tg_pconv_eval_mma_f32.argtypes = [_P] * 12 + [_I] * 12 + [_P]
    lib.tg_pconv_eval_c1_f32.restype = _I
    lib.tg_pconv_eval_c1_f32.argtypes = [_P] * 9 + [_I] * 9 + [_P]
    lib.tg_pconv_c1_info.restype = _I
    lib.tg_pconv_c1_info.argtypes = [_P] * 5
    lib.tg_pconv_mma_smem_bytes.restype = _I
    lib.tg_pconv_mma_smem_bytes.argtypes = [_I, _I]
    lib.tg_pack_tf32_planes.restype = _I
    lib.tg_pack_tf32_planes.argtypes = [_P] * 6 + [_I, _P]
    lib.tg_upsample2x_fwd.restype = _I
    # N, H, W, C, dtype, the plan's tiles (a struct) and grid
    lib.tg_upsample2x_fwd.argtypes = [_P, _P] + [_I] * 5 + [_P, _I, _P]
    lib.tg_upsample2x_bwd.restype = _I
    lib.tg_upsample2x_bwd.argtypes = [_P, _P] + [_I] * 5 + [_P, _I, _P]
    lib.tg_decoder_tail_f32.restype = _I
    lib.tg_decoder_tail_f32.argtypes = [_P] * 12 + [_I] * 4 + [_P]
    lib.tg_decoder_tail_info.restype = _I
    lib.tg_decoder_tail_info.argtypes = [_P] * 4
    # x_l, x_g, s, the three weights' two planes, y_l, y_g; B, H, W, Ca, Cb,
    # Nl, Ng and the stream
    lib.tg_ffc_local_f32.restype = _I
    lib.tg_ffc_local_f32.argtypes = [_P] * 11 + [_I] * 7 + [_P]
    lib.tg_ffc_local_info.restype = _I
    lib.tg_ffc_local_info.argtypes = [_P] * 5
    # g_l, g_g, the three weights, their rotations' two planes, the scratch
    # (the border, g's frame), grad x_l, grad x_g; B, H, W, Ca, Cb, Nl, Ng,
    # need and the stream
    lib.tg_ffc_dgrad_f32.restype = _I
    lib.tg_ffc_dgrad_f32.argtypes = [_P] * 14 + [_I] * 8 + [_P]
    lib.tg_ffc_dgrad_scratch.restype = ctypes.c_longlong  # B, H, W, Ca, Cb, Nl, Ng
    lib.tg_ffc_dgrad_scratch.argtypes = [_I] * 7
    # x_l, x_g, g_l, g_g, the partial sums, the three weights' gradients;
    # B, H, W, Ca, Cb, Nl, Ng, need, splits and the stream
    lib.tg_ffc_wgrad_f32.restype = _I
    lib.tg_ffc_wgrad_f32.argtypes = [_P] * 8 + [_I] * 9 + [_P]
    lib.tg_ffc_wgrad_info.restype = _I
    lib.tg_ffc_wgrad_info.argtypes = [_P] * 6
    # P1, P2 and P4 take n, c and the plan's variant, grid and block; P3
    # m, c, n and the plan's variant, grid, block, rows and K chunk; P5
    # rows, row elements and the plan's variant, grid and block
    for name, n_ptr, n_int in (("lane_reduce", 3, 5), ("matvec_dot", 3, 5),
                               ("lane_concat_dot", 3, 8), ("mask_broadcast", 3, 5),
                               ("row_build", 2, 5), ("empty", 0, 0)):
        fn = getattr(lib, f"tg_probe_{name}")
        fn.restype = _I
        fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        srcs, deps = _sources()
        so = BUILD_ROOT / _digest(srcs + deps) / LIB_NAME
        log_path = so.with_name("nvcc.log")  # ptxas's report, read again by a cached load
        built = not so.exists()
        if built:
            log = _compile(find_nvcc(), srcs, so)
            log_path.write_text(log)
        else:
            log = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(so))
        _bind(lib)
        _info.update(
            path=str(so), built=built, seconds=time.perf_counter() - t0,
            sources=[str(p.relative_to(CSRC.parents[1])) for p in srcs],
            flags=list(NVCC_FLAGS), log=log,
        )
        _lib = lib
        return lib


def build_info() -> Dict[str, object]:
    """What the last load_library did: path, built, seconds, sources, flags, log."""
    return dict(_info)


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
