"""Peaks of the card and the work of the port's hand-written kernel K1.

Peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity), which assume the card's full 700 W power limit; a run prints the
card's actual limit beside any share stated against them.

K1 (``csrc/knn2.cu``) finds, for every query descriptor, its two nearest
train descriptors. The work that one launch needs is that of its valid
rows and valid columns only: 2 * rows * cols * dim floating-point
operations for the cross terms (FP32 on the CUDA cores, no TF32), and
each valid descriptor read once, each valid row's three outputs (two
int32 indices and a bool) written once, the masks read once. A kernel
that also sweeps the empty slots of its fixed capacity does work that
this count leaves out, and its share shows it.
"""

from __future__ import annotations

H100_FP32_FLOPS = 67e12  # CUDA-core FP32, FLOP/s
H100_HBM_BYTES = 3.35e12  # HBM3, bytes/s
H100_POWER_W = 700.0  # the power limit the peaks assume


def k1_flops(rows: int, cols: int, dim: int = 128) -> float:
    return 2.0 * rows * cols * dim


def k1_bytes(rows: int, cols: int, dim: int = 128, slots0: int = 0, slots1: int = 0) -> float:
    """Descriptors of the valid rows and columns (float32) read once, the
    two validity masks (bool, all slots) read once, idx0, idx1 (int32) and
    valid (bool) of each valid row written once."""
    return 4.0 * dim * (rows + cols) + (slots0 + slots1) + 9.0 * rows


def k1_bound_s(launches) -> tuple[float, str]:
    """(least seconds, what bounds them) for launches [(rows, cols, dim,
    slots0, slots1)] at the card's published peaks."""
    flops = sum(k1_flops(r, c, d) for r, c, d, _, _ in launches)
    nbytes = sum(k1_bytes(r, c, d, s0, s1) for r, c, d, s0, s1 in launches)
    t_ops, t_bytes = flops / H100_FP32_FLOPS, nbytes / H100_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def share_percent(bound_s: float, measured_s: float):
    """The share of the roofline in %, or None when nothing was measured."""
    if not measured_s > 0.0:
        return None
    return 100.0 * bound_s / measured_s
