"""Build the port's CUDA sources (``csrc/*.cu``) into shared libraries.

Each source is compiled with ``nvcc`` on first use into
``sfm_mvs_tpu_torch/_build/`` (listed in .gitignore), cached by a hash of
the source and the flags, and loaded with ``ctypes`` by its wrapper.
Nothing is compiled at import time, so the wrappers import on a machine
without nvcc or a GPU.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# sm_90a (Hopper), a plain C interface, and the register/spill report.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return path


def compile_library(src: Path, flags: list, stem: str) -> tuple[Path, str]:
    """Compile `src` with `flags` into ``_build/lib<stem>_<hash>.so``.

    Returns (the library's path, the compiler's output), the output empty
    where the library was built before.
    """
    tag = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{stem}_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    os.replace(tmp, out)
    return out, log


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
