"""Batched DLT triangulation.

PyTorch port of ``sfm_mvs_tpu/ops/triangulation.py``: the homogeneous DLT
system of every correspondence is solved at once in inhomogeneous form —
3x3 normal equations closed by an adjugate inverse, elementwise math only.
"""

from __future__ import annotations

import torch


def triangulate_points(P1, P2, pts1, pts2) -> torch.Tensor:
    """DLT-triangulate N correspondences.

    P1, P2: (..., 3, 4) projection matrices. pts1, pts2: (N, 2) or
    (..., N, 2) pixel coords. Returns homogeneous points (..., N, 4) with
    last component 1. With X = (x, y, z, 1) the 4-row DLT system A X = 0
    becomes the least squares A[:, :3] x = -A[:, 3], rows normalized for
    float32 conditioning.
    """
    P1 = P1[..., None, :, :]
    P2 = P2[..., None, :, :]
    rows = torch.broadcast_tensors(
        pts1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        pts1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        pts2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        pts2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    )
    A = torch.stack(rows, dim=-2)  # (..., N, 4, 4)
    norm = torch.linalg.norm(A, dim=-1, keepdim=True)
    A = A / torch.clamp_min(norm, 1e-12)
    M = A[..., :3]
    b = -A[..., 3]
    AtA = M.transpose(-1, -2) @ M  # (..., N, 3, 3)
    Atb = (M.transpose(-1, -2) @ b[..., None])[..., 0]
    a, b_, c = AtA[..., 0, 0], AtA[..., 0, 1], AtA[..., 0, 2]
    d, e, f = AtA[..., 1, 0], AtA[..., 1, 1], AtA[..., 1, 2]
    g, h, i = AtA[..., 2, 0], AtA[..., 2, 1], AtA[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b_ * i
    c02 = b_ * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b_ * g - a * h
    c22 = a * e - b_ * d
    det = a * c00 + b_ * c10 + c * c20
    inv_det = torch.where(det.abs() < 1e-18, torch.zeros_like(det), 1.0 / det)
    r0, r1, r2 = Atb[..., 0], Atb[..., 1], Atb[..., 2]
    x = torch.stack(
        [
            c00 * r0 + c01 * r1 + c02 * r2,
            c10 * r0 + c11 * r1 + c12 * r2,
            c20 * r0 + c21 * r1 + c22 * r2,
        ],
        dim=-1,
    ) * inv_det[..., None]
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def triangulate_euclidean(P1, P2, pts1, pts2) -> torch.Tensor:
    """Like :func:`triangulate_points` but returns Euclidean (..., N, 3)."""
    return triangulate_points(P1, P2, pts1, pts2)[..., :3]


def triangulation_depths(Rt1, Rt2, X):
    """Camera-frame depths of Euclidean points X (..., N, 3) in both cameras."""
    d1 = (X * Rt1[..., None, 2, :3]).sum(-1) + Rt1[..., None, 2, 3]
    d2 = (X * Rt2[..., None, 2, :3]).sum(-1) + Rt2[..., None, 2, 3]
    return d1, d2
