"""Perspective-n-Point: DLT and planar minimal solvers + Gauss-Newton polish.

PyTorch port of ``sfm_mvs_tpu/ops/pnp.py``. The minimal solvers are
batched over leading dimensions so RANSAC solves every hypothesis in one
call; the polish is a damped Gauss-Newton on (axis-angle, translation)
with a closed-form Jacobian (the JAX package differentiates with
``jax.jacfwd``; forward-mode AD in eager PyTorch costs thousands of small
kernel launches per polish).
"""

from __future__ import annotations

import math

import torch

from sfm_mvs_tpu_torch.ops import homography, lie, linalg, projection


def _weighted_center(X, w):
    wsum = torch.clamp_min(w.sum(-1), 1e-6)
    mean = (X * w[..., None]).sum(-2) / wsum[..., None]
    return mean, X - mean[..., None, :], wsum


def pnp_dlt(X, uv_norm, weights=None, method: str = "svd") -> torch.Tensor:
    """DLT pose from n>=6 3D-2D correspondences (normalized image coords).

    X: (..., N, 3); uv_norm: (..., N, 2); weights: optional (..., N).
    Returns Rt (..., 3, 4), R projected onto SO(3), sign fixed by majority
    positive depth.
    """
    w = torch.ones_like(X[..., 0]) if weights is None else weights
    mean, Xc, wsum = _weighted_center(X, w)
    rms = torch.sqrt(((Xc * Xc).sum(-1) * w).sum(-1) / wsum)
    s = math.sqrt(3.0) / torch.clamp_min(rms, 1e-9)
    Xn = Xc * s[..., None, None]

    x, y, z = Xn[..., 0], Xn[..., 1], Xn[..., 2]
    u, v = uv_norm[..., 0], uv_norm[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    row_u = torch.stack(
        [x, y, z, one, zero, zero, zero, zero, -u * x, -u * y, -u * z, -u], dim=-1)
    row_v = torch.stack(
        [zero, zero, zero, zero, x, y, z, one, -v * x, -v * y, -v * z, -v], dim=-1)
    A = torch.cat([row_u * w[..., None], row_v * w[..., None]], dim=-2)
    if method == "inviter":
        p = linalg.smallest_eigvec(A.transpose(-1, -2) @ A)
    elif method == "eigh":
        p = linalg.eigh(A.transpose(-1, -2) @ A)[1][..., :, 0]
    else:
        p = linalg.svd(A)[2][..., -1, :]
    P = p.reshape(p.shape[:-1] + (3, 4))

    # Undo the 3D conditioning: X_n = s*(X - mean)  =>  P_orig = P @ S.
    zeros3 = torch.zeros_like(mean)
    S = torch.cat([
        torch.cat([s[..., None, None] * torch.eye(3, dtype=X.dtype, device=X.device),
                   (-s[..., None] * mean)[..., :, None]], dim=-1),
        torch.cat([zeros3, torch.ones_like(s)[..., None]], dim=-1)[..., None, :],
    ], dim=-2)
    P = P @ S

    depths = (X * P[..., None, 2, :3]).sum(-1) + P[..., None, 2, 3]
    sign = torch.sign((torch.sign(depths) * w).sum(-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    P = P * sign[..., None, None]

    M = P[..., :3]
    sv = linalg.svdvals(M)
    scale = torch.exp(torch.log(torch.clamp_min(sv, 1e-12)).mean(-1))
    R = lie.orthonormalize(M / scale[..., None, None])
    t = P[..., 3] / scale[..., None]
    return torch.cat([R, t[..., :, None]], dim=-1)


def pnp_planar(X, uv_norm, weights=None, method: str = "svd") -> torch.Tensor:
    """Pose from a world-plane homography (planar-degenerate-safe PnP).

    Fits the sample's dominant plane by weighted PCA, estimates the
    homography from in-plane coordinates to normalized image coordinates,
    and decomposes H = s [R e1 | R e2 | R m + t] (Zhang-style).
    X: (..., N, 3); uv_norm: (..., N, 2). Returns Rt (..., 3, 4).
    """
    w = torch.ones_like(X[..., 0]) if weights is None else weights
    mean, Xc, wsum = _weighted_center(X, w)
    cov = (Xc * w[..., None]).transpose(-1, -2) @ Xc / wsum[..., None, None]
    _, evecs = linalg.eigh(cov)  # ascending
    e1 = evecs[..., :, 2]
    e2 = evecs[..., :, 1]
    pu = (Xc * e1[..., None, :]).sum(-1)
    pv = (Xc * e2[..., None, :]).sum(-1)
    H = homography.homography_dlt(torch.stack([pu, pv], dim=-1), uv_norm, w, method=method)
    H = H * torch.where(H[..., 2, 2] > 0, 1.0, -1.0)[..., None, None]
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    n1 = torch.linalg.norm(h1, dim=-1)
    n2 = torch.linalg.norm(h2, dim=-1)
    s = torch.sqrt(torch.clamp_min(n1 * n2, 1e-12))
    r1 = h1 / torch.clamp_min(n1, 1e-12)[..., None]
    r2 = h2 - (r1 * h2).sum(-1, keepdim=True) * r1
    r2 = r2 / torch.clamp_min(torch.linalg.norm(r2, dim=-1, keepdim=True), 1e-12)
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    E = torch.stack([e1, e2, e3], dim=-1)  # world basis as columns
    R = torch.stack([r1, r2, r3], dim=-1) @ E.transpose(-1, -2)
    R = lie.orthonormalize(R)
    t = h3 / s[..., None] - (R @ mean[..., :, None])[..., 0]
    return torch.cat([R, t[..., :, None]], dim=-1)


def _pose_residuals_and_jacobian(params, X, uv_pix, m, K):
    """Masked pixel residuals (2N,) of the pose params = (axis-angle w, t)
    and their Jacobian (2N, 6), in closed form.

    With Xc = R(w) X + t and h = K Xc, u = h0 / h2 and v = h1 / h2:
    du/dXc = (K[0] - u K[2]) / h2 (likewise v), dXc/dt = I, and
    d(R(w) X)/dw = -R [X]x J_r(w), where J_r(w) = I - b [w]x + c [w]x^2 is
    the right Jacobian of SO(3) (a = sin/theta, b = (1 - cos)/theta^2,
    c = (1 - a)/theta^2, with Taylor forms near 0 as in lie.so3_exp).
    """
    w, t = params[:3], params[3:]
    theta2 = (w * w).sum()
    theta = torch.sqrt(theta2 + lie._EPS * lie._EPS)
    small = theta2 < lie._EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    W = lie.hat(w)
    eye = torch.eye(3, dtype=params.dtype, device=params.device)
    R = eye + a * W + b * (W @ W)
    Jr = eye - b * W + c * (W @ W)

    Xc = X @ R.T + t
    h = Xc @ K.T
    den = h[:, 2:3]
    den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    uv = h[:, :2] / den
    res = (uv - uv_pix) * m[:, None]  # (N, 2)
    # d(u, v)/dXc: (N, 2, 3)
    dxc = (K[None, :2, :] - uv[:, :, None] * K[None, 2:3, :]) / den[:, :, None]
    # d/dw of a row vector g . (R X): (X x (g R)) J_r
    gR = dxc @ R  # (N, 2, 3)
    dw = torch.linalg.cross(X[:, None, :].expand_as(gR), gR, dim=-1) @ Jr
    J = torch.cat([dw, dxc], dim=-1) * m[:, None, None]  # (N, 2, 6)
    return res.reshape(-1), J.reshape(-1, 6)


def refine_pose_gauss_newton(Rt, X, uv_pix, mask, K, iters: int = 10,
                             damping: float = 1e-6) -> torch.Tensor:
    """Damped Gauss-Newton polish of one pose on masked reprojection error.

    Rt: (3,4); X: (N,3); uv_pix: (N,2); mask: (N,). Each step solves the
    6x6 normal equations on the (axis-angle, translation) parameters with
    the closed-form Jacobian; a step that raises the masked sum of squares
    is rejected.
    """
    rvec0, tvec0 = lie.matrix_to_rt(Rt)
    m = mask.to(Rt.dtype)
    eye = torch.eye(6, dtype=Rt.dtype, device=Rt.device)
    params = torch.cat([rvec0, tvec0])
    r, J = _pose_residuals_and_jacobian(params, X, uv_pix, m, K)
    for _ in range(iters):
        H = J.T @ J + damping * eye
        new_params = params - linalg.solve(H, J.T @ r)
        r_new, J_new = _pose_residuals_and_jacobian(new_params, X, uv_pix, m, K)
        better = (r_new * r_new).sum() < (r * r).sum()
        params = torch.where(better, new_params, params)
        r = torch.where(better, r_new, r)
        J = torch.where(better, J_new, J)
    return lie.rt_to_matrix(params[:3], params[3:])


def pnp_residual_pixels(Rt, X, uv_pix, K) -> torch.Tensor:
    """Per-point reprojection distance in pixels: (..., N) for Rt (..., 3, 4)."""
    res = projection.project(X, Rt, K) - uv_pix
    return torch.linalg.norm(res, dim=-1)
