"""Fixed-capacity masked-array utilities.

PyTorch port of ``sfm_mvs_tpu/ops/masking.py``. Every array keeps its
capacity; validity is a boolean mask, and "compaction" is a stable
permutation that moves valid entries to the prefix (so uniform random ints
in [0, count) index only valid entries).
"""

from __future__ import annotations

import torch


def compact_order(mask: torch.Tensor) -> torch.Tensor:
    """Stable permutation putting True entries of `mask` first. (N,) -> (N,)."""
    return torch.argsort((~mask).to(torch.int8), stable=True)


def compact(mask: torch.Tensor, *arrays: torch.Tensor):
    """Move valid rows to the prefix of each array.

    Returns (count, compacted_mask, *compacted_arrays). All shapes static.
    """
    order = compact_order(mask)
    count = mask.sum()
    return (count, mask[order]) + tuple(a[order] for a in arrays)


def scatter_back(order_mask: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Inverse of a compaction permutation: values compacted by
    ``compact(order_mask, ...)`` back in their original order."""
    inv = torch.argsort(compact_order(order_mask), stable=True)
    return values[inv]


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None) -> torch.Tensor:
    """Mean of x over the True entries of mask (0 where there are none)."""
    m = mask.to(x.dtype)
    if axis is None:
        return (x * m).sum() / torch.clamp_min(m.sum(), 1.0)
    return (x * m).sum(axis) / torch.clamp_min(m.sum(axis), 1.0)


def pad_to(x: torch.Tensor, capacity: int, fill=0) -> torch.Tensor:
    """Pad with `fill`, or truncate, the leading axis to `capacity`."""
    n = x.shape[0]
    if n >= capacity:
        return x[:capacity]
    pad = torch.full((capacity - n,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])

