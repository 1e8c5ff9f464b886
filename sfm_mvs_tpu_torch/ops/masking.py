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

