"""Homography estimation (4-point DLT) + transfer error.

PyTorch port of ``sfm_mvs_tpu/ops/homography.py``, batched over leading
dimensions so RANSAC solves all hypotheses in one call.
"""

from __future__ import annotations

import math

import torch

from sfm_mvs_tpu_torch.ops import linalg


def _condition(p: torch.Tensor, w: torch.Tensor, wsum: torch.Tensor):
    """Weighted Hartley conditioning: (..., N, 2) -> (normalized, T (..., 3, 3))."""
    mean = (p * w[..., None]).sum(-2) / wsum[..., None]
    c = p - mean[..., None, :]
    rms = torch.sqrt(((c * c).sum(-1) * w).sum(-1) / wsum)
    s = math.sqrt(2.0) / torch.clamp_min(rms, 1e-9)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zero, -s * mean[..., 0]], dim=-1),
        torch.stack([zero, s, -s * mean[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return c * s[..., None, None], T


def homography_dlt(pts1, pts2, weights=None, method: str = "svd") -> torch.Tensor:
    """DLT homography H s.t. pts2 ~ H pts1 from n>=4 correspondences.

    pts1, pts2: (..., N, 2); weights: optional (..., N). Returns (..., 3, 3)
    scaled so that H[2, 2] = 1.
    method: "svd" of the design matrix, "eigh" or "inviter" (damped inverse
    iteration, the fast path for RANSAC batches) of its Gram matrix.
    """
    w = torch.ones_like(pts1[..., 0]) if weights is None else weights
    wsum = torch.clamp_min(w.sum(-1), 1e-6)
    n1, T1 = _condition(pts1, w, wsum)
    n2, T2 = _condition(pts2, w, wsum)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    one = torch.ones_like(x1)
    zero = torch.zeros_like(x1)
    row1 = torch.stack([zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2], dim=-1)
    row2 = torch.stack([x1, y1, one, zero, zero, zero, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([row1 * w[..., None], row2 * w[..., None]], dim=-2)
    if method == "inviter":
        Hn = linalg.smallest_eigvec(A.transpose(-1, -2) @ A)
    elif method == "eigh":
        Hn = linalg.eigh(A.transpose(-1, -2) @ A)[1][..., :, 0]
    else:
        Hn = linalg.svd(A)[2][..., -1, :]
    Hn = Hn.reshape(Hn.shape[:-1] + (3, 3))
    H = torch.linalg.inv_ex(T2)[0] @ Hn @ T1
    h22 = H[..., 2, 2]
    return H / torch.clamp_min(h22.abs(), 1e-12)[..., None, None] * torch.sign(h22)[..., None, None]


def transfer_error(H, pts1, pts2) -> torch.Tensor:
    """Forward transfer distance |H p1 - p2| in pixels.

    H: (..., 3, 3); pts1, pts2: (N, 2). Returns (..., N).
    """
    h = torch.cat([pts1, torch.ones_like(pts1[:, :1])], dim=-1) @ H.transpose(-1, -2)
    den = h[..., 2:3]
    proj = h[..., :2] / torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    return torch.linalg.norm(proj - pts2, dim=-1)


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Warp 2D points by H. (N, 2) -> (N, 2)."""
    h = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=-1) @ H.T
    w = h[:, 2:3]
    return h[:, :2] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
