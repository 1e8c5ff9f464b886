"""Brute-force KNN descriptor matching with fused Lowe-ratio test.

PyTorch port of ``sfm_mvs_tpu/ops/matching.py``. These are the plain
versions: the full (N0, N1) squared-distance matrix as one float32 matrix
product (``dist^2 = |a|^2 + |b|^2 - 2 a.b``), then a top-2 reduction and
the ratio test. They serve CPU tensors, the mutual check and
``use_pallas_matcher=False``; :func:`match_with_config` sends CUDA tensors
to the hand-written kernel in ``ops/matching_cuda.py`` otherwise.

The ratio test matches the reference: keep a match when d1 < ratio * d2 on
L2 distances, i.e. d1^2 < ratio^2 * d2^2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 3.0e38


class Matches(NamedTuple):
    idx0: torch.Tensor  # (M,) int32 feature index in image 0
    idx1: torch.Tensor  # (M,) int32 feature index in image 1
    valid: torch.Tensor  # (M,) bool


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 per row, the one reduction the plain version and the CUDA
    kernel's wrapper share, so both see bitwise the same norms."""
    return (x * x).sum(-1)


def distance_matrix(
    desc0: torch.Tensor, desc1: torch.Tensor, valid1: torch.Tensor
) -> torch.Tensor:
    """Squared L2 distances (N0, N1); invalid train columns get 3e38."""
    sq0 = squared_norms(desc0)[:, None]
    sq1 = squared_norms(desc1)[None, :]
    cross = desc0 @ desc1.T
    d2 = torch.clamp_min((sq0 + sq1) - 2.0 * cross, 0.0)
    return torch.where(valid1[None, :], d2, torch.full_like(d2, BIG))


def top2(d2: torch.Tensor):
    """Per-row two smallest distances + argmin (lowest column on ties).

    Returns (d1, j1, d2nd): best distance, its column, second-best distance.
    """
    j1 = torch.argmin(d2, dim=1)
    d1 = torch.gather(d2, 1, j1[:, None])[:, 0]
    cols = torch.arange(d2.shape[1], device=d2.device)
    masked = torch.where(cols[None, :] == j1[:, None], torch.full_like(d2, BIG), d2)
    d2nd = masked.min(dim=1).values
    return d1, j1, d2nd


def knn_match(
    desc0: torch.Tensor,
    desc1: torch.Tensor,
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    ratio: float = 0.70,
    mutual: bool = False,
) -> Matches:
    """k=2 brute-force match with Lowe ratio filter.

    desc0: (N0, D); desc1: (N1, D); valid*: (N*,) feature-slot validity.
    Returns Matches of length N0: slot i holds the best train index for
    query i; `valid` marks matches that survive the ratio test (and,
    optionally, a mutual-nearest check).
    """
    d2 = distance_matrix(desc0, desc1, valid1)
    d1, j1, d2nd = top2(d2)
    ok = valid0 & (d1 < (ratio * ratio) * d2nd) & (d1 < BIG)
    if mutual:
        d2_t = torch.where(valid0[None, :], d2.T, torch.full_like(d2.T, BIG))
        back = torch.argmin(d2_t, dim=1)  # (N1,) best query for each train
        ok = ok & (back[j1] == torch.arange(desc0.shape[0], device=desc0.device))
    idx0 = torch.arange(desc0.shape[0], dtype=torch.int32, device=desc0.device)
    return Matches(idx0=idx0, idx1=j1.to(torch.int32), valid=ok)


def match_with_config(desc0, desc1, valid0, valid1, cfg) -> Matches:
    """Route to the CUDA 2-NN kernel or the plain matcher.

    cfg: FrontendConfig. The route follows the JAX package's
    (``matching.py:107-114``): the fused kernel serves
    ``use_pallas_matcher and not mutual_check``; the plain version serves
    the mutual check and ``use_pallas_matcher=False``. The kernel's wrapper
    itself takes the plain version for CPU tensors.
    """
    if getattr(cfg, "use_pallas_matcher", True) and not cfg.mutual_check:
        from sfm_mvs_tpu_torch.ops.matching_cuda import knn_match_cuda

        return knn_match_cuda(desc0, desc1, valid0, valid1, ratio=cfg.lowe_ratio)
    return knn_match(
        desc0, desc1, valid0, valid1, ratio=cfg.lowe_ratio, mutual=cfg.mutual_check
    )


def gather_match_points(kp0: torch.Tensor, kp1: torch.Tensor, matches: Matches):
    """Matched pixel-coordinate arrays, invalid rows zeroed.

    kp0, kp1: (N, 2) keypoint positions. Returns (pts0 (M,2), pts1 (M,2),
    valid (M,)).
    """
    pts0 = kp0[matches.idx0.long()]
    pts1 = kp1[matches.idx1.long()]
    v = matches.valid[:, None]
    zero = torch.zeros((), dtype=kp0.dtype, device=kp0.device)
    return torch.where(v, pts0, zero), torch.where(v, pts1, zero), matches.valid
