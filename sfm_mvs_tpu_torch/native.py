"""ctypes binding for the native host runtime (``native/sfm_native.cc``).

The port's counterpart of ``sfm_mvs_tpu/native.py``: the same C++ source
and entry points (JPEG/PNG decode to float32, the cv2.pyrDown-equivalent
downscale, PLY export), without the JAX package. The library is declared to
``ops/cuda_build.py``, which compiles it with ``g++`` from the checkout's
source into the git-ignored ``sfm_mvs_tpu_torch/_build/`` on first use,
never at import. It needs the libjpeg and libpng headers; where they are
missing the build fails once and every entry point takes its plain
fallback: PIL decode, the port's ``ops/pyramid.pyr_down``,
``utils/io.to_ply``'s numpy writer. Native calls
release the GIL, so the ``ImageLoader`` prefetcher overlaps decode with
device work.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import numpy as np

from sfm_mvs_tpu_torch.ops import cuda_build

_SRC = Path(__file__).resolve().parent.parent / "native" / "sfm_native.cc"
_f32p = ctypes.POINTER(ctypes.c_float)
_i, _ip, _s = ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p


def _cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler: the native host runtime cannot be built")
    return cxx


LIB = cuda_build.Library(
    _SRC, "sfm_native", ["-O3", "-fPIC", "-fopenmp", "-Wall", "-shared"],
    functions={"sn_image_size": (_i, [_s, _ip, _ip]),
               "sn_decode_gray_f32": (_i, [_s, _f32p, _i]),
               "sn_decode_bgr_f32": (_i, [_s, _f32p, _i]),
               "sn_pyr_down_f32": (None, [_f32p, _i, _i, _f32p]),
               "sn_write_ply": (_i, [_s, _f32p, _f32p, _i, ctypes.c_float, ctypes.c_float, _i])},
    compiler=_cxx, libs=["-ljpeg", "-lpng"])


def _load():
    """The bound library, or None where it does not build or load here
    (e.g. no libjpeg headers, or a cached build whose libjpeg is absent)."""
    try:
        return LIB.load()
    except (RuntimeError, OSError):
        return None


def available() -> bool:
    return bool(_load())


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def image_size(path: str) -> tuple[int, int]:
    lib = _load()
    if not lib:
        from PIL import Image

        with Image.open(path) as im:
            return im.size[1], im.size[0]
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.sn_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"cannot decode {path}")
    return h.value, w.value


def decode_gray(path: str) -> np.ndarray:
    """(H, W) float32 grayscale in [0, 1]."""
    lib = _load()
    if not lib:
        from sfm_mvs_tpu_torch.utils import io

        return io.load_image_gray(path)
    h, w = image_size(path)
    out = np.empty((h, w), dtype=np.float32)
    rc = lib.sn_decode_gray_f32(path.encode(), _ptr(out), h * w)
    if rc != 0:
        raise IOError(f"decode failed ({rc}): {path}")
    return out


def decode_bgr(path: str) -> np.ndarray:
    """(H, W, 3) float32 BGR in [0, 255]."""
    lib = _load()
    if not lib:
        from sfm_mvs_tpu_torch.utils import io

        return io.load_image_bgr(path)
    h, w = image_size(path)
    out = np.empty((h, w, 3), dtype=np.float32)
    rc = lib.sn_decode_bgr_f32(path.encode(), _ptr(out), h * w * 3)
    if rc != 0:
        raise IOError(f"decode failed ({rc}): {path}")
    return out


def pyr_down(img: np.ndarray) -> np.ndarray:
    """Host-side cv2.pyrDown-equivalent (5-tap binomial + 2x decimate)."""
    lib = _load()
    img = np.ascontiguousarray(img, dtype=np.float32)
    if img.ndim == 3:
        return np.stack([pyr_down(img[..., c]) for c in range(img.shape[-1])], -1)
    h, w = img.shape
    if not lib:
        import torch

        from sfm_mvs_tpu_torch.ops.pyramid import pyr_down as tp

        return tp(torch.as_tensor(img)).numpy()
    out = np.empty(((h + 1) // 2, (w + 1) // 2), dtype=np.float32)
    lib.sn_pyr_down_f32(_ptr(img), h, w, _ptr(out))
    return out


def write_ply(path: str, points: np.ndarray, colors_bgr: np.ndarray,
              scale: float = 200.0, outlier_offset: float = 300.0,
              binary: bool = False) -> int:
    """PLY export with reference cleaning semantics. Returns #vertices."""
    lib = _load()
    if not lib:
        from sfm_mvs_tpu_torch.utils import io

        return io.to_ply(path, points, colors_bgr, scale, outlier_offset)
    pts = np.ascontiguousarray(points.reshape(-1, 3), dtype=np.float32)
    cols = np.ascontiguousarray(colors_bgr.reshape(-1, 3), dtype=np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rc = lib.sn_write_ply(path.encode(), _ptr(pts), _ptr(cols), len(pts),
                          float(scale), float(outlier_offset), int(binary))
    if rc < 0:
        raise IOError(f"ply write failed: {path}")
    return rc


class ImageLoader:
    """Threaded prefetching loader: decode (+ optional downscale) off the
    critical path."""

    def __init__(self, paths: Sequence[str], downscale: int = 1, load_color: bool = True,
                 workers: int = 2, prefetch: int = 4):
        self.paths = list(paths)
        self.downscale = downscale
        self.load_color = load_color
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._futures: dict[int, object] = {}
        self._prefetch = prefetch

    def _work(self, idx: int):
        g = decode_gray(self.paths[idx])
        b = decode_bgr(self.paths[idx]) if self.load_color else None
        d = self.downscale
        while d > 1:
            g = pyr_down(g)
            if b is not None:
                b = pyr_down(b)
            d //= 2
        return g, b

    def _ensure(self, idx: int):
        if idx < len(self.paths) and idx not in self._futures:
            self._futures[idx] = self._pool.submit(self._work, idx)

    def get(self, idx: int):
        """(gray, bgr_or_None) for frame idx; schedules prefetch ahead."""
        self._ensure(idx)
        for ahead in range(1, self._prefetch + 1):
            self._ensure(idx + ahead)
        return self._futures.pop(idx).result()

    def __len__(self):
        return len(self.paths)

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
