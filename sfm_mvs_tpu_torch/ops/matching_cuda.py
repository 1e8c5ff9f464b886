"""Hand-written CUDA 2-NN matcher: the Hopper port of the TPU kernel.

Replaces ``sfm_mvs_tpu/ops/matching_pallas.py:_knn2_kernel`` (wrapper
``knn_match_pallas``). The kernel source is ``csrc/knn2.cu``; see its
header for the design. In short: what bounds it on the H100 is FP32 FMA
throughput — about 4.3 GFLOP per call at the main-path shape 4096 x 4096 x
128 — while the plain version (``ops/matching.py``) writes and re-reads a
64 MiB distance matrix; the kernel keeps each distance in registers,
folds it into a per-thread running top-2, and never writes the matrix. It
sums the cross term with FP32 FMA on the CUDA cores (no TF32), and rounds
the distance epilogue with explicit ``__fadd_rn``/``__fmul_rn``/``__fsub_rn``
so it matches the plain expression ``max((|q|^2+|t|^2) - 2 q.t, 0)``.

The library is compiled from the checkout's source with ``nvcc`` for
``sm_90a`` on first use, into ``sfm_mvs_tpu_torch/_build/`` (listed in
.gitignore), and bound with ``ctypes``. Nothing is compiled or loaded at
import time, so this module imports on a machine without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from sfm_mvs_tpu_torch.ops.matching import (
    BIG, Matches, knn_match, squared_norms,
)

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "knn2.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Launches of the CUDA kernel since the last reset (one per wrapper call
# that launched it; CPU calls do not count).
launches = 0

_lib = None
_lib_lock = threading.Lock()
build_log = ""


def reset_launches() -> None:
    global launches
    launches = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA 2-NN kernel cannot be built")
    return path


def build() -> Path:
    """Compile csrc/knn2.cu into a shared library (cached by source hash).

    Returns the library path. The compiler's register/spill report is kept
    in the module attribute ``build_log``.
    """
    global build_log
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    out = _BUILD_DIR / f"libknn2_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True,
    )
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{build_log}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.knn2_launch.argtypes = [p, p, p, p, p, i, i, i, i, p, p, p, p, p, p, p]
            lib.knn2_launch.restype = i
            for name in ("knn2_tile_rows", "knn2_tile_cols", "knn2_max_dim"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = i
            _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def knn2_raw(desc0, desc1, valid1):
    """Launch the kernel: (d1, j1, d2) per query row, before the ratio test.

    desc0: (N0, D) float32, desc1: (N1, D) float32, valid1: (N1,) bool, all
    contiguous on one CUDA device; D a multiple of 16, at most 128.
    """
    global launches
    _check("desc0", desc0, torch.float32, 2)
    _check("desc1", desc1, torch.float32, 2)
    _check("valid1", valid1, torch.bool, 1)
    n0, d = desc0.shape
    n1 = desc1.shape[0]
    lib = _load()
    if desc1.shape[1] != d or valid1.shape[0] != n1:
        raise ValueError(
            f"shape mismatch: desc0 {tuple(desc0.shape)}, desc1 "
            f"{tuple(desc1.shape)}, valid1 {tuple(valid1.shape)}")
    if d % 16 or d > lib.knn2_max_dim() or d == 0:
        raise ValueError(f"descriptor width {d} unsupported (multiple of 16, <= 128)")
    if n1 < 1 or n0 < 1:
        raise ValueError(f"empty descriptor set: N0={n0}, N1={n1}")
    if not (desc0.device == desc1.device == valid1.device):
        raise ValueError("desc0, desc1 and valid1 must be on one device")
    dev = desc0.device
    qsq = squared_norms(desc0)
    tsq = squared_norms(desc1)
    tv = valid1.view(torch.uint8)
    # Split the train axis so that query tiles x splits fills the SMs twice.
    row_tiles = -(-n0 // lib.knn2_tile_rows())
    col_tiles = -(-n1 // lib.knn2_tile_cols())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(col_tiles, -(-2 * sms // row_tiles)))
    part_b1 = torch.empty((n0, splits), dtype=torch.float32, device=dev)
    part_b2 = torch.empty((n0, splits), dtype=torch.float32, device=dev)
    part_j = torch.empty((n0, splits), dtype=torch.int32, device=dev)
    d1 = torch.empty((n0,), dtype=torch.float32, device=dev)
    j1 = torch.empty((n0,), dtype=torch.int32, device=dev)
    d2 = torch.empty((n0,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knn2_launch(
            desc0.data_ptr(), qsq.data_ptr(), desc1.data_ptr(), tsq.data_ptr(),
            tv.data_ptr(), n0, n1, d, splits, part_b1.data_ptr(),
            part_b2.data_ptr(), part_j.data_ptr(), d1.data_ptr(),
            j1.data_ptr(), d2.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"knn2 kernel launch failed with CUDA error {err}")
    launches += 1
    return d1, j1, d2


def knn_match_cuda(
    desc0: torch.Tensor,
    desc1: torch.Tensor,
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    ratio: float = 0.70,
) -> Matches:
    """Drop-in for ``matching.knn_match`` with ``mutual=False``.

    On CUDA tensors it launches the kernel (or raises); on CPU tensors it
    returns the plain version's result.
    """
    if desc0.device.type == "cpu":
        return knn_match(desc0, desc1, valid0, valid1, ratio=ratio)
    _check("valid0", valid0, torch.bool, 1)
    if valid0.shape[0] != desc0.shape[0] or valid0.device != desc0.device:
        raise ValueError(f"valid0 {tuple(valid0.shape)} on {valid0.device} does not "
                         f"fit desc0 {tuple(desc0.shape)} on {desc0.device}")
    d1, j1, d2 = knn2_raw(desc0, desc1, valid1)
    ok = valid0 & (d1 < (ratio * ratio) * d2) & (d1 < BIG)
    idx0 = torch.arange(desc0.shape[0], dtype=torch.int32, device=desc0.device)
    return Matches(idx0=idx0, idx1=j1, valid=ok)
