"""Hand-written CUDA 2-NN matcher: the Hopper port of the TPU kernel.

Replaces ``sfm_mvs_tpu/ops/matching_pallas.py:_knn2_kernel`` (wrapper
``knn_match_pallas``). The kernel source is ``csrc/knn2.cu``; see its
header for the design. In short: what bounds it on the H100 is FP32 FMA
throughput — about 4.3 GFLOP per call at the main-path shape 4096 x 4096 x
128, 64.1 us at the card's 67 TFLOP/s — while the plain version
(``ops/matching.py``) writes and re-reads a 64 MiB distance matrix. A
tile kernel (128 x 128 block tiles, 8 x 8 per thread, train chunks
streamed through a cp.async ring) keeps each distance in registers and
folds it into a running top-2 per split of the train axis
(:func:`plan_splits`); a merge kernel folds the splits and applies the
ratio test. It sums the cross term with FP32 FMA on the CUDA cores (no
TF32), and rounds the distance epilogue with explicit
``__fadd_rn``/``__fmul_rn``/``__fsub_rn`` so it matches the plain
expression ``max((|q|^2+|t|^2) - 2 q.t, 0)``. A call launches six device
ops: the two norm reductions (``matching.squared_norms``, a product and a
sum each, shared with the plain version so both see the same norms) and
the two kernels.

:func:`knn_match_cuda_batch` matches B pairs of one shape in one launch of
the same two kernels (the batch is the grid's third axis), the counterpart
of the JAX package's vmapped matcher; each pair's outputs equal its single
launch's bit for bit.

The library (``LIB``) is declared to ``ops/cuda_build.py``, which compiles
the checkout's source with ``nvcc`` for ``sm_90a`` on first use and binds
it with ``ctypes``. Nothing is compiled or loaded at import time, so this
module imports on a machine without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from sfm_mvs_tpu_torch.ops import cuda_build
from sfm_mvs_tpu_torch.ops.matching import Matches, knn_match, squared_norms
from sfm_mvs_tpu_torch.utils import profiling

_SRC = cuda_build.CSRC / "knn2.cu"

# The kernel's block tile and widest descriptor (checked against the
# library's own when it loads), and the blocks it keeps resident per SM
# (its __launch_bounds__).
TILE = 128
MAX_DIM = 128
BLOCKS_PER_SM = 2

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = cuda_build.Library(
    _SRC, "knn2", cuda_build.NVCC_FLAGS,
    functions={"knn2_launch": (_i, [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p, _p, _p, _p,
                                    _p, _f, _p, _p, _i, _p])},
    constants={"knn2_tile_rows": TILE, "knn2_tile_cols": TILE, "knn2_max_dim": MAX_DIM},
    mismatch="tiles {got}, wrapper expects {want}")


def build() -> Path:
    """Compile csrc/knn2.cu into a shared library (cached by source hash).

    Returns the library path. The compiler's register/spill report is kept
    in ``LIB.log``.
    """
    return LIB.build()


@functools.lru_cache(maxsize=64)
def plan_splits(n0: int, n1: int, sms: int, batch: int = 1) -> tuple[int, int]:
    """(splits, tiles_per_split) of the train axis for the tile kernel.

    The grid is (query row tiles) x splits x `batch` pairs; split s walks
    the column tiles [s * tiles_per_split, (s + 1) * tiles_per_split), so
    the splits cover every column tile exactly once. The split count is the
    one with the fewest tile-steps per SM slot, waves x tiles_per_split,
    with BLOCKS_PER_SM resident blocks on each of `sms` SMs (the fewest
    splits on ties): where batch x row tiles already fill the slots, that
    is one split.
    """
    row_tiles = -(-n0 // TILE)
    col_tiles = -(-n1 // TILE)
    slots = sms * BLOCKS_PER_SM
    best = None
    for s in range(1, col_tiles + 1):
        per = -(-col_tiles // s)
        used = -(-col_tiles // per)  # no empty split
        cost = -(-batch * row_tiles * used // slots) * per
        if best is None or cost < best[0]:
            best = (cost, used, per)
    return best[1], best[2]


@functools.lru_cache(maxsize=16)
def _sm_count(idx: int) -> int:
    return torch.cuda.get_device_properties(idx).multi_processor_count


def _launch(desc0, desc1, valid1, valid0=None, ratio=0.0):
    """Both kernels, for one pair (2-D descriptors) or a batch of pairs
    (3-D, leading axis B). Returns (work, jj, ok): d1 and d2 are the last
    2 * B * N0 floats of `work` (after the per-split partials), jj (2, [B,]
    N0) holds idx0 and j1, ok the ratio test (None without `valid0`).

    Traced as the span ``k1``, with the counters ``k1.launches`` (single
    pairs) or ``k1.batch_launches`` and ``k1.batch_pairs``, ``k1.slots``
    (the rows x columns the launch sweeps) and ``k1.valid_pairs`` (valid
    rows x valid columns, summed over the pairs: five small device ops on
    the H100 beside the call's six, only while the tracer is on).
    """
    with profiling.span("k1"):
        return _launch_kernels(desc0, desc1, valid1, valid0, ratio)


def _launch_kernels(desc0, desc1, valid1, valid0, ratio):
    nd = desc0.dim()
    if nd not in (2, 3):
        raise ValueError(f"desc0 must be (N0, D) or (B, N0, D), got {tuple(desc0.shape)}")
    cuda_build.check_tensor("desc0", desc0, torch.float32, ndim=nd)
    cuda_build.check_tensor("desc1", desc1, torch.float32, ndim=nd)
    cuda_build.check_tensor("valid1", valid1, torch.bool, ndim=nd - 1)
    lead = tuple(desc0.shape[:-2])
    b = desc0.shape[0] if nd == 3 else 1
    n0, d = desc0.shape[-2:]
    n1 = desc1.shape[-2]
    if (desc1.shape[-1] != d or tuple(desc1.shape[:-2]) != lead
            or tuple(valid1.shape) != lead + (n1,)):
        raise ValueError(
            f"shape mismatch: desc0 {tuple(desc0.shape)}, desc1 "
            f"{tuple(desc1.shape)}, valid1 {tuple(valid1.shape)}")
    if d % 16 or d > MAX_DIM or d == 0:
        raise ValueError(f"descriptor width {d} unsupported (multiple of 16, <= {MAX_DIM})")
    if n1 < 1 or n0 < 1 or b < 1:
        raise ValueError(f"empty descriptor set: B={b}, N0={n0}, N1={n1}")
    dev = desc0.device
    if not (desc1.device == valid1.device == dev):
        raise ValueError("desc0, desc1 and valid1 must be on one device")
    if valid0 is not None:
        cuda_build.check_tensor("valid0", valid0, torch.bool, ndim=nd - 1)
        if tuple(valid0.shape) != lead + (n0,) or valid0.device != dev:
            raise ValueError(f"valid0 {tuple(valid0.shape)} on {valid0.device} does not "
                             f"fit desc0 {tuple(desc0.shape)} on {dev}")
    lib = LIB.load()
    qsq = squared_norms(desc0)
    tsq = squared_norms(desc1)
    splits, per = plan_splits(n0, n1, _sm_count(dev.index), b)
    n_part = 3 * b * n0 * splits
    work = torch.empty((n_part + 2 * b * n0,), dtype=torch.float32, device=dev)
    jj = torch.empty((2,) + lead + (n0,), dtype=torch.int32, device=dev)  # idx0, j1
    ok = torch.empty(lead + (n0,), dtype=torch.bool, device=dev) if valid0 is not None else None
    w = work.data_ptr()
    d_ptr = w + 4 * n_part  # d1, then d2
    err = lib.knn2_launch(
        desc0.data_ptr(), qsq.data_ptr(), desc1.data_ptr(), tsq.data_ptr(),
        valid1.data_ptr(), b, n0, n1, d, splits, per, w,
        d_ptr, jj.data_ptr() + 4 * b * n0, d_ptr + 4 * b * n0,
        None if valid0 is None else valid0.data_ptr(),
        ratio * ratio,  # rounded to float32, as the plain version's scalar is
        None if valid0 is None else jj.data_ptr(),
        None if ok is None else ok.data_ptr(), dev.index, cuda_build.current_stream(dev),
    )
    if err != 0:
        raise RuntimeError(f"knn2 kernel launch failed with CUDA error {err}")
    if profiling.enabled():
        if nd == 3:
            profiling.count("k1.batch_launches")
            profiling.count("k1.batch_pairs", b)
        else:
            profiling.count("k1.launches")
        profiling.count("k1.slots", b * n0 * n1)
        pairs = (n0 if valid0 is None else valid0.sum(-1)) * valid1.sum(-1)
        profiling.count("k1.valid_pairs", pairs if nd == 2 else pairs.sum())
    return work, jj, ok


def knn2_raw(desc0, desc1, valid1):
    """Launch the kernel: (d1, j1, d2) per query row, before the ratio test.

    desc0: (N0, D) float32, desc1: (N1, D) float32, valid1: (N1,) bool, all
    contiguous on one CUDA device; D a multiple of 16, at most 128. With a
    leading batch axis on all three (B pairs of one shape) it is one
    batched launch, and each output gains that axis.
    """
    work, jj, _ = _launch(desc0, desc1, valid1)
    shape = desc0.shape[:-1]
    d1, d2 = work[-2 * shape.numel():].view((2,) + tuple(shape))
    return d1, jj[1], d2


def knn_match_cuda(
    desc0: torch.Tensor,
    desc1: torch.Tensor,
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    ratio: float = 0.70,
) -> Matches:
    """Drop-in for ``matching.knn_match`` with ``mutual=False``.

    On CUDA tensors it launches the kernels (or raises): two norm
    reductions, the tile kernel and the merge kernel, which also applies
    the ratio test and writes idx0. On CPU tensors it returns the plain
    version's result.
    """
    return _knn_match(desc0, desc1, valid0, valid1, ratio)


def knn_match_cuda_batch(
    desc0: torch.Tensor,
    desc1: torch.Tensor,
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    ratio: float = 0.70,
) -> Matches:
    """``knn_match_cuda`` for B pairs of one shape in one launch.

    desc0 (B, N0, D), desc1 (B, N1, D), valid0 (B, N0), valid1 (B, N1).
    On CUDA tensors it launches the kernels once for the batch (counted in
    ``k1.batch_launches``; ``k1.batch_pairs`` grows by B) and raises on anything
    but contiguous float32 descriptors and bool masks; each pair's outputs
    equal its single launch's. On CPU tensors it returns the plain batched
    version's result.
    """
    if desc0.device.type != "cpu" and desc0.dim() != 3:
        raise ValueError(f"desc0 must be (B, N0, D), got {tuple(desc0.shape)}")
    return _knn_match(desc0, desc1, valid0, valid1, ratio)


def _knn_match(desc0, desc1, valid0, valid1, ratio) -> Matches:
    """Both public matchers' body: the plain version on CPU tensors, else
    one launch for one pair or a batch (the leading axis of 3-D inputs)."""
    if desc0.device.type == "cpu":
        return knn_match(desc0, desc1, valid0, valid1, ratio=ratio)
    _, jj, ok = _launch(desc0, desc1, valid1, valid0, ratio)
    idx0, j1 = jj
    return Matches(idx0=idx0, idx1=j1, valid=ok)
