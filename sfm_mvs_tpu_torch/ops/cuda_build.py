"""Build, load and bind the port's native libraries: one seam for all three.

:class:`Library` is how a wrapper declares its library: the source, the
compiler and flags, the C functions it binds and the constants it shares
with the source. Each source is compiled on first use into
``sfm_mvs_tpu_torch/_build/`` (listed in .gitignore), cached by a hash of
the source and the flags, and loaded once with ``ctypes``. Nothing is
compiled at import time, so the wrappers import on a machine without nvcc
or a GPU. The CUDA sources are ``csrc/*.cu`` (K1 and MVS pass 1); the host
runtime, ``native/sfm_native.cc``, is built with the C++ compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# sm_90a (Hopper), a plain C interface, and the register/spill report.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# A build that takes longer raises subprocess.TimeoutExpired (each takes seconds).
_BUILD_TIMEOUT_S = 300


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return path


def compile_library(src: Path, flags: list, stem: str,
                    compiler: Callable[[], str] = nvcc, libs: list = ()) -> tuple[Path, str]:
    """Compile `src` with `flags`, linking `libs`, into
    ``_build/lib<stem>_<hash>.so``; `compiler` returns the compiler's path
    and is asked only where the library was not built before.

    Returns (the library's path, the compiler's output), the output empty
    where the library was built before. The library appears atomically, so
    concurrent builders race harmlessly; a failed build raises RuntimeError.
    """
    tag = hashlib.sha1(src.read_bytes() + " ".join([*flags, *libs]).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{stem}_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cc = compiler()
    proc = subprocess.run([cc, *flags, "-o", str(tmp), str(src), *libs],
                          capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cc).name} failed on {src}:\n{log}")
    os.replace(tmp, out)
    return out, log


class Library:
    """A native library as its wrapper declares it: built on first use,
    loaded once under a lock, its C functions bound, its constants checked.

    functions: {C function: (restype, argtypes)}. constants: {C function of
    no arguments returning int: the wrapper's value}; where the library's
    differ, loading raises RuntimeError, "<source name> " + `mismatch`
    formatted with the tuples `got` and `want`. compiler: returns the
    compiler's path. A build or load that fails once is not tried again in
    this process: every later :meth:`load` raises RuntimeError. ``log``
    keeps the compiler's output of this process's build (the ptxas
    register/spill report of a CUDA source).
    """

    def __init__(self, src: Path, stem: str, flags: list, functions: dict,
                 constants: dict | None = None, mismatch: str = "",
                 compiler: Callable[[], str] = nvcc, libs: list = ()):
        self.src, self.stem, self.flags, self.libs = src, stem, flags, list(libs)
        self.functions, self.constants, self.mismatch = functions, constants or {}, mismatch
        self.compiler = compiler
        self.log = ""
        self._lib = None
        self._error = None
        self._lock = threading.Lock()

    def build(self) -> Path:
        """Compile the source (cached by source and flags hash); returns the
        library's path."""
        path, log = compile_library(self.src, self.flags, self.stem, self.compiler, self.libs)
        if log:
            self.log = log
        return path

    def load(self) -> ctypes.CDLL:
        """The bound library, built and loaded on the first call."""
        with self._lock:
            if self._lib is None:
                if self._error is not None:
                    raise RuntimeError(self._error)
                try:
                    self._lib = self._bind(ctypes.CDLL(str(self.build())))
                except (RuntimeError, OSError) as e:
                    self._error = f"{self.src.name} did not build or load: {e}"
                    raise
        return self._lib

    def _bind(self, lib: ctypes.CDLL) -> ctypes.CDLL:
        for name, (restype, argtypes) in self.functions.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        for name in self.constants:
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = ctypes.c_int, []
        got = tuple(getattr(lib, name)() for name in self.constants)
        want = tuple(self.constants.values())
        if got != want:
            raise RuntimeError(f"{self.src.name} " + self.mismatch.format(got=got, want=want))
        return lib


def check_tensor(name: str, x: torch.Tensor, dtype: torch.dtype, *, ndim: int | None = None,
                 shape: tuple | None = None, device: torch.device | None = None) -> None:
    """Raise ValueError unless `x` is a contiguous CUDA tensor of `dtype`
    (and `ndim` dims, `shape`, on `device`, where given): what a kernel
    takes through a raw pointer."""
    if x.device.type != "cuda" or (device is not None and x.device != device):
        where = "" if device is None else f" on {device}"
        raise ValueError(f"{name} must be a CUDA tensor{where}, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if ndim is not None and x.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(x.shape)}")
    if shape is not None and tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def current_stream(dev: torch.device) -> int:
    """The raw handle of `dev`'s current stream: what
    ``torch.cuda.current_stream`` gives, without building a Stream object on
    every launch."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def ptxas_report(log: str) -> dict:
    """{kernel entry: (registers, spill bytes)} from an ``-Xptxas -v`` log
    (mangled entry names)."""
    out, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
            out[entry] = [None, None]
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[entry][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[entry][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}
