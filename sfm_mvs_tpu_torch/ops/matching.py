"""Brute-force KNN descriptor matching with fused Lowe-ratio test.

PyTorch port of ``sfm_mvs_tpu/ops/matching.py``. These are the plain
versions: the full (N0, N1) squared-distance matrix as one float32 matrix
product (``dist^2 = |a|^2 + |b|^2 - 2 a.b``), then a top-2 reduction and
the ratio test. They serve CPU tensors, the mutual check and
``use_pallas_matcher=False``; :func:`match_with_config` sends CUDA tensors
to the hand-written kernel in ``ops/matching_cuda.py`` otherwise.

The ratio test matches the reference: keep a match when d1 < ratio * d2 on
L2 distances, i.e. d1^2 < ratio^2 * d2^2.

Every function here also takes a leading batch axis, B pairs of one shape
(the JAX package's ``parallel/frontend.match_batch`` vmaps its matcher).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 3.0e38


class Matches(NamedTuple):
    idx0: torch.Tensor  # ([B,] M) int32 feature index in image 0
    idx1: torch.Tensor  # ([B,] M) int32 feature index in image 1
    valid: torch.Tensor  # ([B,] M) bool


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 per row, the one reduction the plain version and the CUDA
    kernel's wrapper share, so both see bitwise the same norms."""
    return (x * x).sum(-1)


def distance_matrix(
    desc0: torch.Tensor, desc1: torch.Tensor, valid1: torch.Tensor
) -> torch.Tensor:
    """Squared L2 distances ([B,] N0, N1); invalid train columns get 3e38."""
    sq0 = squared_norms(desc0)[..., :, None]
    sq1 = squared_norms(desc1)[..., None, :]
    cross = desc0 @ desc1.transpose(-1, -2)
    d2 = torch.clamp_min((sq0 + sq1) - 2.0 * cross, 0.0)
    return torch.where(valid1[..., None, :], d2, torch.full_like(d2, BIG))


def top2(d2: torch.Tensor):
    """Per-row two smallest distances + argmin (lowest column on ties) of
    ([B,] N0, N1).

    Returns (d1, j1, d2nd): best distance, its column, second-best distance.
    """
    j1 = torch.argmin(d2, dim=-1)
    d1 = torch.gather(d2, -1, j1[..., None])[..., 0]
    cols = torch.arange(d2.shape[-1], device=d2.device)
    masked = torch.where(cols == j1[..., None], torch.full_like(d2, BIG), d2)
    d2nd = masked.min(dim=-1).values
    return d1, j1, d2nd


def ratio_test(valid0: torch.Tensor, d1: torch.Tensor, d2nd: torch.Tensor,
               ratio: float) -> torch.Tensor:
    """Lowe's test on squared distances: valid0 & d1 < ratio^2 * d2nd & d1 < 3e38.

    ``ratio * ratio`` is a Python float that torch rounds to float32 before
    the one float32 product; the CUDA merge kernel rounds the same way.
    """
    return valid0 & (d1 < (ratio * ratio) * d2nd) & (d1 < BIG)


def knn_match(
    desc0: torch.Tensor,
    desc1: torch.Tensor,
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    ratio: float = 0.70,
    mutual: bool = False,
) -> Matches:
    """k=2 brute-force match with Lowe ratio filter.

    desc0: ([B,] N0, D); desc1: ([B,] N1, D); valid*: ([B,] N*) feature-slot
    validity. Returns Matches of length N0 (per pair): slot i holds the best
    train index for query i; `valid` marks matches that survive the ratio
    test (and, optionally, a mutual-nearest check).
    """
    d2 = distance_matrix(desc0, desc1, valid1)
    d1, j1, d2nd = top2(d2)
    ok = ratio_test(valid0, d1, d2nd, ratio)
    n0 = desc0.shape[-2]
    rows = torch.arange(n0, device=desc0.device)
    if mutual:
        d2_t = d2.transpose(-1, -2)
        d2_t = torch.where(valid0[..., None, :], d2_t, torch.full_like(d2_t, BIG))
        back = torch.argmin(d2_t, dim=-1)  # ([B,] N1) best query for each train
        ok = ok & (torch.gather(back, -1, j1) == rows)
    idx0 = rows.to(torch.int32).expand(j1.shape)
    return Matches(idx0=idx0, idx1=j1.to(torch.int32), valid=ok)


def match_with_config(desc0, desc1, valid0, valid1, cfg) -> Matches:
    """Route to the CUDA 2-NN kernel or the plain matcher.

    cfg: FrontendConfig. The route follows the JAX package's
    (``matching.py:107-114``): the fused kernel serves
    ``use_pallas_matcher and not mutual_check``; the plain version serves
    the mutual check and ``use_pallas_matcher=False``. The kernel's wrapper
    itself takes the plain version for CPU tensors. A batch of pairs
    (3-D descriptors) takes the same route: one batched kernel launch.
    """
    if getattr(cfg, "use_pallas_matcher", True) and not cfg.mutual_check:
        from sfm_mvs_tpu_torch.ops import matching_cuda

        match = (matching_cuda.knn_match_cuda_batch if desc0.dim() == 3
                 else matching_cuda.knn_match_cuda)
        return match(desc0, desc1, valid0, valid1, ratio=cfg.lowe_ratio)
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
