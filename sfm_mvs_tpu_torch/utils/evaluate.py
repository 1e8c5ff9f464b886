"""Trajectory evaluation: similarity alignment + absolute trajectory error.

The reference has no quantitative evaluation (SURVEY.md §4); BASELINE.json
asks for trajectory parity within an ATE bound. SfM reconstructions are
defined up to a similarity transform, so ATE uses Umeyama alignment of the
estimated camera centers to ground truth.
"""

from __future__ import annotations

import numpy as np


def camera_centers(poses: np.ndarray) -> np.ndarray:
    """World-frame camera centers C = -R^T t from (N, 3, 4) [R|t]."""
    R = poses[:, :, :3]
    t = poses[:, :, 3]
    return -np.einsum("nij,ni->nj", R, t)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray):
    """Similarity (s, R, t) minimizing ||s R src + t - dst||^2. (N,3) each."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = np.trace(np.diag(D) @ S) / var_s
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """RMSE of aligned camera centers (the standard ATE metric)."""
    est_c = camera_centers(np.asarray(est_poses))
    gt_c = camera_centers(np.asarray(gt_poses))
    s, R, t = umeyama_alignment(est_c, gt_c)
    aligned = est_c @ (s * R).T + t
    return float(np.sqrt(((aligned - gt_c) ** 2).sum(axis=1).mean()))


def rotation_errors_deg(est_poses: np.ndarray, gt_poses: np.ndarray) -> np.ndarray:
    """Per-camera relative rotation error (degrees) after global alignment.

    Uses the first camera to fix the gauge: compares R_i R_0^T between
    estimate and ground truth.
    """
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)
    R0e = est[0, :, :3]
    R0g = gt[0, :, :3]
    errs = []
    for i in range(len(est)):
        Re = est[i, :, :3] @ R0e.T
        Rg = gt[i, :, :3] @ R0g.T
        dR = Re @ Rg.T
        c = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
        errs.append(np.degrees(np.arccos(c)))
    return np.asarray(errs)
