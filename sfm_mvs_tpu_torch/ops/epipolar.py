"""Essential-matrix estimation and pose recovery.

PyTorch port of ``sfm_mvs_tpu/ops/epipolar.py`` (the parts the
incremental path runs): the normalized 8-point solver with projection onto
the essential manifold (batched over hypotheses), Sampson residuals, the
4-candidate decomposition with cheirality voting (cv2.recoverPose), the
homography-based pose for near-planar pairs, and a Gauss-Newton polish of
the relative pose on the 5-dof manifold.
"""

from __future__ import annotations

import torch

from sfm_mvs_tpu_torch.ops import lie, linalg, triangulation


def essential_eight_point(pts1, pts2, weights=None, method: str = "svd"):
    """Weighted 8-point essential matrix on *normalized camera* coordinates.

    pts1, pts2: (..., N, 2); weights: optional (..., N). Returns E:
    (..., 3, 3) with singular values (1, 1, 0). method "svd" takes the null
    vector from the SVD of the design matrix, "eigh" from its Gram matrix.
    """
    x1, y1 = pts1[..., 0], pts1[..., 1]
    x2, y2 = pts2[..., 0], pts2[..., 1]
    ones = torch.ones_like(x1)
    A = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1
    )
    if weights is not None:
        A = A * weights[..., None]
    if method == "eigh":
        e = linalg.eigh(A.transpose(-1, -2) @ A)[1][..., :, 0]
    else:
        e = linalg.svd(A)[2][..., -1, :]
    E = e.reshape(e.shape[:-1] + (3, 3))
    U, _, Vt = linalg.svd(E)
    diag = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * diag) @ Vt


def sampson_error(E, pts1, pts2) -> torch.Tensor:
    """Squared Sampson distance per correspondence.

    E: (..., 3, 3); pts1, pts2: (N, 2) in E's coordinate frame. Returns
    (..., N).
    """
    x1 = torch.cat([pts1, torch.ones_like(pts1[:, :1])], dim=-1)
    x2 = torch.cat([pts2, torch.ones_like(pts2[:, :1])], dim=-1)
    Ex1 = x1 @ E.transpose(-1, -2)  # (..., N, 3)
    Etx2 = x2 @ E
    x2tEx1 = (x2 * Ex1).sum(-1)
    denom = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return (x2tEx1 * x2tEx1) / torch.clamp_min(denom, 1e-12)


def epipolar_residual_pixels(E, pts1, pts2, focal) -> torch.Tensor:
    """Sampson distance (not squared) rescaled to ~pixels by the focal."""
    return torch.sqrt(sampson_error(E, pts1, pts2)) * focal


def decompose_essential(E: torch.Tensor):
    """E (3, 3) -> the 4 candidate (R, t): (Rs (4,3,3), ts (4,3)).

    Candidates are (R1, +t), (R1, -t), (R2, +t), (R2, -t), t unit-norm.
    """
    U, _, Vt = linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def refine_relative_pose(R0, t0, pts1, pts2, mask, iters: int = 10,
                         damping: float = 1e-8):
    """Gauss-Newton refinement of a relative pose on inlier Sampson error.

    5-dof manifold: a left-multiplied axis-angle increment of R and two
    tangent coordinates of the unit translation. A step that raises the
    masked sum of squares is rejected, so the call never degrades its
    input. The Jacobian comes from forward-mode AD.
    """
    dtype, dev = R0.dtype, R0.device
    t0 = t0 / torch.clamp_min(torch.linalg.norm(t0), 1e-12)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=dev)
    ref = torch.where(t0[0].abs() < 0.9, ex, ey)
    b1 = torch.linalg.cross(t0, ref)
    b1 = b1 / torch.clamp_min(torch.linalg.norm(b1), 1e-12)
    b2 = torch.linalg.cross(t0, b1)
    m = mask.to(dtype)

    def unpack(p):
        R = lie.so3_exp(p[:3]) @ R0
        t = t0 + p[3] * b1 + p[4] * b2
        return R, t / torch.clamp_min(torch.linalg.norm(t), 1e-12)

    def residuals(p):
        R, t = unpack(p)
        E = lie.hat(t) @ R
        return torch.sqrt(sampson_error(E, pts1, pts2) + 1e-18) * m

    def sse(p):
        r = residuals(p)
        return (r * r).sum()

    eye = torch.eye(5, dtype=dtype, device=dev)
    p = torch.zeros(5, dtype=dtype, device=dev)
    for _ in range(iters):
        r = residuals(p)
        J = linalg.jacobian(residuals, p)  # (N, 5)
        H = J.T @ J + damping * eye
        cand = p - linalg.solve(H, J.T @ r)
        p = torch.where(sse(cand) < sse(p), cand, p)
    return unpack(p)


def decompose_homography(Hn: torch.Tensor):
    """Faugeras SVD decomposition of a *normalized* homography (3, 3).

    Returns (Rs (4,3,3), ts (4,3), ns (4,3)): the four (R, t/d, n)
    candidates of x2 ~ (R + t n^T) x1, with (t, n) flipped so n_z > 0.
    """
    U, d, Vt = linalg.svd(Hn)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    a = d1 / d2
    c = d3 / d2
    denom = torch.clamp_min(a * a - c * c, 1e-12)
    x1 = torch.sqrt(torch.clamp((a * a - 1.0) / denom, 0.0, 1.0))
    x3 = torch.sqrt(torch.clamp((1.0 - c * c) / denom, 0.0, 1.0))
    sin_t = (a - c) * x1 * x3
    cos_t = a * x3 * x3 + c * x1 * x1
    V = Vt.T
    zero = torch.zeros_like(a)
    one = torch.ones_like(a)
    Rs, ts, ns = [], [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = torch.stack([
                torch.stack([cos_t, zero, -st]),
                torch.stack([zero, one, zero]),
                torch.stack([st, zero, cos_t]),
            ])
            tp = (a - c) * torch.stack([e1 * x1, zero, -e3 * x3])
            np_ = torch.stack([e1 * x1, zero, e3 * x3])
            R = s * U @ Rp @ Vt
            t = U @ tp
            n = V @ np_
            flip = torch.where(n[2] < 0, -1.0, 1.0)
            Rs.append(R)
            ts.append(t * flip)
            ns.append(n * flip)
    return torch.stack(Rs), torch.stack(ts), torch.stack(ns)


def _candidate_poses(Rs: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    return torch.cat([Rs, ts[..., None]], dim=-1)  # (4, 3, 4)


def _identity_pose(like: torch.Tensor) -> torch.Tensor:
    return torch.cat(
        [torch.eye(3, dtype=like.dtype, device=like.device),
         torch.zeros((3, 1), dtype=like.dtype, device=like.device)], dim=1)


def recover_pose_from_homography(Hn, pts1, pts2, mask):
    """Best (R, t) from a normalized homography by cheirality + reprojection.

    pts in normalized camera coordinates. Returns (R, unit t, per-point
    positive-depth mask).
    """
    Rs, ts, _ = decompose_homography(Hn)
    P1 = _identity_pose(Hn)
    Rt2 = _candidate_poses(Rs, ts)
    X = triangulation.triangulate_euclidean(P1, Rt2, pts1, pts2)  # (4, N, 3)
    d1, d2 = triangulation.triangulation_depths(P1, Rt2, X)
    good = (d1 > 0) & (d2 > 0) & mask
    proj2 = X @ Rt2[:, :, :3].transpose(-1, -2) + Rt2[:, None, :, 3]
    den = proj2[..., 2:3]
    uv2 = proj2[..., :2] / torch.where(den.abs() < 1e-9, torch.full_like(den, 1e-9), den)
    sq = ((uv2 - pts2) ** 2).sum(-1)
    err = torch.where(good, sq, torch.zeros_like(sq)).sum(-1)
    scores = good.sum(-1).to(torch.float32) - 1e-3 * err
    best = torch.argmax(scores)
    t_best = ts[best]
    t_best = t_best / torch.clamp_min(torch.linalg.norm(t_best), 1e-12)
    return Rs[best], t_best, good[best]


def recover_pose(E, pts1, pts2, mask):
    """Select the (R, t) candidate with the most points in front of both
    cameras (cv2.recoverPose). pts in normalized camera coordinates.

    Returns (R (3,3), t (3,), cheirality mask (N,)).
    """
    Rs, ts = decompose_essential(E)
    P1 = _identity_pose(E)
    Rt2 = _candidate_poses(Rs, ts)
    X = triangulation.triangulate_euclidean(P1, Rt2, pts1, pts2)
    d1, d2 = triangulation.triangulation_depths(P1, Rt2, X)
    good = (d1 > 0) & (d2 > 0) & mask
    best = torch.argmax(good.sum(-1))
    return Rs[best], ts[best], good[best]
