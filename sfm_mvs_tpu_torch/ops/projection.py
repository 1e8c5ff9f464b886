"""Pinhole projection and homogeneous-coordinate functions.

PyTorch port of ``sfm_mvs_tpu/ops/projection.py``. Point arrays are
fixed-capacity with boolean validity masks. ``project`` and
``project_depth`` take a pose batch (..., 3, 4) and broadcast over it.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _safe_div(num: torch.Tensor, den: torch.Tensor, eps: float) -> torch.Tensor:
    return num / torch.where(den.abs() < eps, torch.full_like(den, eps), den)


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., D+1) by appending ones."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def from_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    """(..., D+1) -> (..., D) by dividing by the last coordinate."""
    return _safe_div(pts[..., :-1], pts[..., -1:], _EPS)


def compose_projection(K: torch.Tensor, Rt: torch.Tensor) -> torch.Tensor:
    """P = K [R|t]. K: (..., 3, 3), Rt: (..., 3, 4) -> (..., 3, 4)."""
    return K @ Rt


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Radial distortion in normalized coords: x_d = x (1 + k1 r^2 + k2 r^4)."""
    r2 = (xy * xy).sum(-1, keepdim=True)
    return xy * (1.0 + dist[0] * r2 + dist[1] * r2 * r2)


def undistort_normalized(xy_d: torch.Tensor, dist: torch.Tensor, iters: int = 5):
    """Invert :func:`distort_normalized` by fixed-point iteration."""
    xy = xy_d
    for _ in range(iters):
        r2 = (xy * xy).sum(-1, keepdim=True)
        f = 1.0 + dist[0] * r2 + dist[1] * r2 * r2
        xy = _safe_div(xy_d, f, _EPS)
    return xy


def undistort_pixels(pts, K, dist, iters: int = 5):
    """Observed (distorted) pixels -> ideal pinhole pixels."""
    xu = undistort_normalized(normalize_points(pts, K), dist, iters=iters)
    return torch.stack(
        [xu[..., 0] * K[0, 0] + K[0, 2], xu[..., 1] * K[1, 1] + K[1, 2]], dim=-1
    )


def _to_camera(points: torch.Tensor, Rt: torch.Tensor) -> torch.Tensor:
    """World points (N, 3) -> camera frame (..., N, 3) for poses (..., 3, 4)."""
    return points @ Rt[..., :3, :3].transpose(-1, -2) + Rt[..., None, :3, 3]


def project(points, Rt, K, dist=None) -> torch.Tensor:
    """Project world points into pixel coordinates.

    points: (N, 3); Rt: (..., 3, 4); K: (3, 3); dist: optional (2,) =
    (k1, k2). Returns (..., N, 2).
    """
    Xc = _to_camera(points, Rt)
    if dist is None:
        return from_homogeneous(Xc @ K.T)
    xy = _safe_div(Xc[..., :2], Xc[..., 2:], _EPS)
    xd = distort_normalized(xy, dist)
    return torch.stack(
        [xd[..., 0] * K[0, 0] + K[0, 2], xd[..., 1] * K[1, 1] + K[1, 2]], dim=-1
    )


def project_depth(points, Rt, K):
    """Like :func:`project` but also returns the camera-frame depth (..., N)."""
    Xc = _to_camera(points, Rt)
    return from_homogeneous(Xc @ K.T), Xc[..., 2]


def reprojection_residuals(points, observed, Rt, K) -> torch.Tensor:
    """Per-point 2D pixel residual (projected - observed). (N, 2)."""
    return project(points, Rt, K) - observed


def masked_mean_reprojection_error(points, observed, Rt, K, mask) -> torch.Tensor:
    """sqrt(sum of squared coordinate residuals) / N over valid entries.

    The reference's audit metric (cv2.norm(..., NORM_L2)/len), kept
    bug-compatible with the JAX package — not the mean per-point norm.
    """
    res = reprojection_residuals(points, observed, Rt, K)
    sq = torch.where(mask[:, None], res * res, torch.zeros_like(res)).sum()
    n = torch.clamp_min(mask.sum(), 1)
    return torch.sqrt(sq) / n


def masked_rms_reprojection_error(points, observed, Rt, K, mask) -> torch.Tensor:
    """RMS per-point reprojection error in pixels."""
    res = reprojection_residuals(points, observed, Rt, K)
    sq = (res * res).sum(-1)
    n = torch.clamp_min(mask.sum(), 1)
    return torch.sqrt(torch.where(mask, sq, torch.zeros_like(sq)).sum() / n)


def normalize_points(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel coords -> normalized camera coords via K^{-1}. pts: (..., 2)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    skew = K[0, 1]
    y = (pts[..., 1] - cy) / fy
    x = (pts[..., 0] - cx - skew * y) / fx
    return torch.stack([x, y], dim=-1)


def hartley_normalization(pts: torch.Tensor, mask: torch.Tensor):
    """Similarity T s.t. T*pts has zero mean and RMS distance sqrt(2).

    pts: (N, 2), mask: (N,). Returns (pts_normalized (N,2), T (3,3)).
    """
    m = mask.to(pts.dtype)[:, None]
    n = torch.clamp_min(m.sum(), 1.0)
    mean = (pts * m).sum(0) / n
    centered = pts - mean
    rms = torch.sqrt(((centered * centered).sum(-1) * m[:, 0]).sum() / n)
    scale = math.sqrt(2.0) / torch.clamp_min(rms, _EPS)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[0]]),
        torch.stack([zero, scale, -scale * mean[1]]),
        torch.stack([zero, zero, one]),
    ])
    return centered * scale, T
