"""Hand-written CUDA kernels of MVS pass 1: the plane sweep and the
zero-mean pyramid, one launch each a pyramid level.

They replace no TPU kernel: the JAX package leaves the sweep to XLA. The
source is ``csrc/mvs_sweep.cu``; see its header for the design and what
bounds it. In short: :func:`sweep_select` computes what
``models/mvs.py:_sweep_select_plain`` computes for all the hypotheses of a
level in one launch (each block owns a 32 x 32 output tile of one
reference and loops over the hypotheses, keeping the box-filtered costs in
shared memory and the selection in registers; no cost volume reaches
device memory), and :func:`zero_mean` computes ``x - _box_filter(x, r)``
for a level's references and neighbours together. The plain version runs
each hypothesis as ~250 small ATen ops.

Arithmetic follows the plain code's float32 roundings (the source is
built with ``-fmad=false``; ``fmaf`` where the plain code uses addcmul).
The one intended difference is the box filter's summation order: direct
window sums in place of differences of float32 prefix sums.

Each launch adds 1 to the tracer's counter ``mvs.sweep_kernel``. The
wrappers launch on the current stream,
never synchronize, and raise on inputs the kernels do not take.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from sfm_mvs_tpu_torch.ops import cuda_build
from sfm_mvs_tpu_torch.utils import profiling

_SRC = cuda_build.CSRC / "mvs_sweep.cu"
# No contraction of a product and a sum into one FMA: the kernels round
# where the plain expressions round, and write fmaf where they fuse.
_NVCC_FLAGS = cuda_build.NVCC_FLAGS + ["-fmad=false"]

TILE = 32  # output tile side (checked against the library's when it loads)
THREADS = 256
# A block's dynamic shared memory may not pass this (H100).
MAX_SMEM = 232448

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = cuda_build.Library(
    _SRC, "mvs_sweep", _NVCC_FLAGS,
    functions={"mvs_sweep_launch": (_i, [_p] * 9 + [_i] * 11 + [_p] * 4 + [_i, _p]),
               "mvs_zero_mean_launch": (_i, [_p] * 4 + [_i] * 8 + [_i, _p])},
    constants={"mvs_tile": TILE, "mvs_threads": THREADS},
    mismatch="tiles {got[0]} x {got[1]} threads, wrapper expects {want[0]} x {want[1]}")


def build() -> Path:
    """Compile csrc/mvs_sweep.cu (cached by source hash); the compiler's
    register/spill report is kept in ``LIB.log``."""
    return LIB.build()


def sweep_plan(batch: int, height: int, width: int, num_nbrs: int, num_uniform: int,
               radius: int) -> tuple[tuple[int, int, int], int]:
    """(grid, dynamic shared bytes) of the sweep kernel: one block per 32 x
    32 output tile of each reference; a block holds its tile with a halo of
    `radius` six times (rays x and y, reference, center, num, den), the row
    pass of the box filter twice (num, den), each neighbour's R_rel and
    t_rel and the uniform offsets."""
    halo = TILE + 2 * radius
    floats = 6 * halo * halo + 2 * halo * TILE + 12 * num_nbrs + num_uniform
    return (-(-width // TILE), -(-height // TILE), batch), 4 * floats


def zero_mean_plan(images: int, height: int, width: int,
                   radius: int) -> tuple[tuple[int, int, int], int]:
    """(grid, dynamic shared bytes) of the zero-mean kernel: one block per
    32 x 32 tile of each image, holding the tile with its halo and the
    row pass."""
    halo = TILE + 2 * radius
    return (-(-width // TILE), -(-height // TILE), images), 4 * (halo * halo + halo * TILE)


def _check(name: str, x: torch.Tensor, shape: tuple, dev: torch.device) -> None:
    cuda_build.check_tensor(name, x, torch.float32, shape=shape, device=dev)


def sweep_select(ref_zm, nbrs_zm, Kl, R_rel, t_rel, center, offsets, cost_radius: int,
                 dist=None, sample_mode: str = "bilinear", extra=()):
    """``_sweep_select`` for CUDA tensors with a batch axis, in one launch.

    ref_zm (B, H, W), nbrs_zm (B, M, H, W), Kl (3, 3), R_rel (B, M, 3, 3),
    t_rel (B, M, 3), center (B, H, W), offsets (B, D), extra: E maps (B, H,
    W); float32, contiguous, on one CUDA device; dist (k1, k2) or None.
    Returns (invd, best_cost, mean_cost, den_best), each (B, H, W).
    """
    if ref_zm.dim() != 3:
        raise ValueError(f"ref_zm must be (B, H, W), got {tuple(ref_zm.shape)}")
    B, H, W = ref_zm.shape
    M, D, E = nbrs_zm.shape[1], offsets.shape[-1], len(extra)
    dev = ref_zm.device
    _check("ref_zm", ref_zm, (B, H, W), dev)
    _check("nbrs_zm", nbrs_zm, (B, M, H, W), dev)
    _check("Kl", Kl, (3, 3), dev)
    _check("R_rel", R_rel, (B, M, 3, 3), dev)
    _check("t_rel", t_rel, (B, M, 3), dev)
    _check("center", center, (B, H, W), dev)
    _check("offsets", offsets, (B, D), dev)
    if sample_mode not in ("nearest", "bilinear"):
        raise ValueError(f"sample_mode must be 'nearest' or 'bilinear', got {sample_mode!r}")
    if min(B, M, D) < 1 or H < 2 or W < 2 or cost_radius < 0:
        raise ValueError(f"sweep of B={B}, M={M}, D={D} at {H}x{W}, radius {cost_radius} "
                         "not supported (B, M, D >= 1, H, W >= 2, radius >= 0)")
    ex = None
    if E:
        ex = torch.stack(list(extra), dim=1)
        _check("extra", ex, (B, E, H, W), dev)
    if dist is not None:
        dist = torch.as_tensor(dist, dtype=torch.float32, device=dev).contiguous()
        _check("dist", dist, (2,), dev)
    grid, smem = sweep_plan(B, H, W, M, D, cost_radius)
    if smem > MAX_SMEM:
        raise ValueError(f"sweep needs {smem} bytes of shared memory a block (radius "
                         f"{cost_radius}, {M} neighbours, {D} hypotheses), over {MAX_SMEM}")
    lib = LIB.load()
    invd, best, mean, den = (torch.empty((B, H, W), dtype=torch.float32, device=dev)
                             for _ in range(4))
    err = lib.mvs_sweep_launch(
        ref_zm.data_ptr(), nbrs_zm.data_ptr(), Kl.data_ptr(), R_rel.data_ptr(), t_rel.data_ptr(),
        center.data_ptr(), offsets.data_ptr(), None if ex is None else ex.data_ptr(),
        None if dist is None else dist.data_ptr(), B, M, H, W, D, E, cost_radius,
        int(sample_mode == "nearest"), grid[0], grid[1], smem, invd.data_ptr(), best.data_ptr(),
        mean.data_ptr(), den.data_ptr(), dev.index, cuda_build.current_stream(dev))
    if err != 0:
        raise RuntimeError(f"mvs sweep kernel launch failed with CUDA error {err}")
    profiling.count("mvs.sweep_kernel", 1)
    return invd, best, mean, den


def zero_mean(refs: torch.Tensor, nbrs: torch.Tensor, radius: int):
    """(refs - box_filter(refs), nbrs - box_filter(nbrs)) with replicate
    edges, in one launch: refs (B, H, W), nbrs (B, M, H, W), float32,
    contiguous, on one CUDA device."""
    if refs.dim() != 3 or nbrs.dim() != 4:
        raise ValueError(f"refs must be (B, H, W) and nbrs (B, M, H, W), got "
                         f"{tuple(refs.shape)} and {tuple(nbrs.shape)}")
    B, H, W = refs.shape
    M = nbrs.shape[1]
    dev = refs.device
    _check("refs", refs, (B, H, W), dev)
    _check("nbrs", nbrs, (B, M, H, W), dev)
    if min(B, H, W) < 1 or radius < 0:
        raise ValueError(f"zero-mean of B={B} at {H}x{W}, radius {radius} not supported")
    grid, smem = zero_mean_plan(B + B * M, H, W, radius)
    if smem > MAX_SMEM:
        raise ValueError(f"zero-mean needs {smem} bytes of shared memory a block (radius "
                         f"{radius}), over {MAX_SMEM}")
    lib = LIB.load()
    refs_out, nbrs_out = torch.empty_like(refs), torch.empty_like(nbrs)
    err = lib.mvs_zero_mean_launch(
        refs.data_ptr(), nbrs.data_ptr(), refs_out.data_ptr(), nbrs_out.data_ptr(), B, B * M, H,
        W, radius, grid[0], grid[1], smem, dev.index, cuda_build.current_stream(dev))
    if err != 0:
        raise RuntimeError(f"mvs zero-mean kernel launch failed with CUDA error {err}")
    profiling.count("mvs.sweep_kernel", 1)
    return refs_out, nbrs_out
