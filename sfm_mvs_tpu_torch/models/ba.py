"""Sparse Levenberg-Marquardt bundle adjustment with Schur complement.

PyTorch port of ``sfm_mvs_tpu/models/ba.py``: cameras are (axis-angle,
translation), points 3-dof, observations fixed, on the map's dense (P, C)
observation grid; optionally with the notebook prototype's intrinsics
[focal scale s, k1, k2] (radial distortion on the normalized coordinates),
shared by all cameras (``refine_intrinsics``) or per camera (a 9-wide
camera block).

- Residuals and their Jacobians (2x6 or 2x9 camera blocks A, 2x3 point
  blocks B, 2x3 shared-intrinsics blocks T) are evaluated for every grid
  cell in closed form (the JAX package differentiates with ``jax.jacfwd``
  under two ``vmap``s): with Xc = R(w) X + t, d(R X)/dw = -R [X]x J_r(w),
  the right Jacobian of SO(3), and dXc/dX = R, as in ``ops/pnp.py``.
- Normal equations: U_c = sum_p A^T A, V_p = sum_c B^T B and
  W_pc = A^T B. Every product has a tiny inner or outer dimension (2x6
  and 2x3 blocks, 3x3 and 6x6 matrix-vector products), so each is a
  broadcast-multiply-then-sum, as in the JAX package: as (batched) GEMMs
  cuBLAS ran them in 0.27-1.0 ms per call on the H100, ~10x the
  elementwise form. W is materialized once per LM iteration as a
  (C*w, P*3) matrix, so that both products of the matrix-free Schur
  complement S = U - W V^-1 W^T are one matrix-vector product each (full
  float32: the package turns TF32 off).
- S is solved by block-Jacobi-preconditioned conjugate gradients.
- The LM accept/reject loop runs ``max_iterations`` steps with no host
  sync: a step counts only while the damping is below 1e5 (the JAX
  ``while_loop``'s condition), so ``iterations`` and ``accepted`` equal the
  JAX package's.

Gauge: camera 0 is frozen (its Jacobian blocks are zeroed, its per-camera
intrinsics too). At the identity intrinsics [1, 0, 0] the projection is the
pinhole ``K [R|t] X`` bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_mvs_tpu_torch.models.map_store import MapState
from sfm_mvs_tpu_torch.ops import lie


class BAProblem(NamedTuple):
    """Fixed-capacity bundle-adjustment problem (a view over MapState)."""

    cam_params: torch.Tensor  # (C, 6) [rvec | tvec], or (C, 9) [... | ds, k1, k2]
    points: torch.Tensor  # (P, 3)
    cam_valid: torch.Tensor  # (C,)
    point_valid: torch.Tensor  # (P,)
    obs_uv: torch.Tensor  # (P, C, 2)
    obs_mask: torch.Tensor  # (P, C)
    K: torch.Tensor  # (3, 3)
    frozen: torch.Tensor  # (C,) bool: cameras excluded from optimization
    intr: torch.Tensor  # (3,) shared [focal_scale, k1, k2]; identity [1, 0, 0]


_INTR_IDENTITY = (1.0, 0.0, 0.0)


class BAStats(NamedTuple):
    initial_cost: torch.Tensor  # () mean squared pixel residual
    final_cost: torch.Tensor
    iterations: torch.Tensor  # () LM iterations executed
    accepted: torch.Tensor  # () accepted steps


def problem_from_map(state: MapState, frozen_first: int = 1,
                     local_window: int = 0) -> BAProblem:
    """Build a BAProblem from the map.

    frozen_first: always freeze the first N cameras (gauge). local_window:
    if > 0, also freeze every camera but the most recent `local_window`.
    """
    rvec, tvec = lie.matrix_to_rt(state.poses)
    cam_idx = torch.arange(state.poses.shape[0], device=state.poses.device)
    frozen = cam_idx < frozen_first
    if local_window > 0:
        frozen = frozen | (cam_idx < state.num_cams - local_window)
    return BAProblem(
        cam_params=torch.cat([rvec, tvec], dim=-1),
        points=state.points,
        cam_valid=state.cam_valid,
        point_valid=state.point_valid,
        obs_uv=state.obs_uv,
        obs_mask=state.obs_mask,
        K=state.K,
        frozen=frozen,
        intr=torch.tensor(_INTR_IDENTITY, dtype=state.points.dtype,
                          device=state.points.device),
    )


def write_back_to_map(state: MapState, prob: BAProblem) -> MapState:
    """Write optimized cameras and points back into the map (the pose is
    cam_params[:, :6] at either width)."""
    poses = lie.rt_to_matrix(prob.cam_params[:, :3], prob.cam_params[:, 3:6])
    return state._replace(poses=poses, points=prob.points)


# ---------------------------------------------------------------------------
# Residuals + Jacobians on the (P, C) grid
# ---------------------------------------------------------------------------


def _rodrigues(w: torch.Tensor):
    """(R, J_r) for rotation vectors w (C, 3): lie.so3_exp's coefficients
    (with its Taylor forms below theta^2 = 1e-8) and the right Jacobian
    J_r = I - b [w]x + c [w]x^2, c = (1 - a) / theta^2."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + lie._EPS * lie._EPS)
    small = theta2 < lie._EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    Wx = lie.hat(w)
    W2 = Wx @ Wx
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    a, b, c = a[:, None, None], b[:, None, None], c[:, None, None]
    return eye + a * Wx + b * W2, eye - b * Wx + c * W2


def _rows_times(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Rows (P, C, n, 3) times per-camera matrices M (C, 3, 3)."""
    return (X[..., 0, None] * M[:, None, 0] + X[..., 1, None] * M[:, None, 1]
            + X[..., 2, None] * M[:, None, 2])


def _res_jac_grid(cam_params, points, obs_uv, K, intr=None, jacobian: bool = True,
                  intr_jacobian: bool = False):
    """Pixel residuals r (P, C, 2) of every grid cell and, with `jacobian`,
    their Jacobians A (P, C, 2, w) w.r.t. the w-wide camera block and
    B (P, C, 2, 3) w.r.t. the point; with `intr_jacobian` also
    T (P, C, 2, 3) w.r.t. the shared intrinsics.

    The projection is ``_residual_one``'s: with Xc = R(w) X + t,
    x = Xc0 / z, y = Xc1 / z (z = 1e-9 where |Xc2| < 1e-9, with zero
    derivative there), r2 = x^2 + y^2 and d = 1 + r2 (k1 + r2 k2),
    u = s d (fx x + skew y) + cx and v = s d fy y + cy. The intrinsics
    [s, k1, k2] are `intr` (3,), the identity [1, 0, 0] when None, or, for
    a 9-wide camera [rvec | tvec | ds, k1, k2], per camera with s = 1 + ds.
    At the identity every value and derivative equals the pinhole's bit
    for bit. d(R X)/dw = -R [X]x J_r(w), the right Jacobian of SO(3), and
    dXc/dX = R, as in ``ops/pnp.py``.
    """
    P, C = points.shape[0], cam_params.shape[0]
    if cam_params.shape[-1] == 9:
        s, k1, k2 = 1.0 + cam_params[:, 6], cam_params[:, 7], cam_params[:, 8]
    else:
        if intr is None:
            intr = torch.tensor(_INTR_IDENTITY, dtype=points.dtype, device=points.device)
        s, k1, k2 = intr[0], intr[1], intr[2]
    R, Jr = _rodrigues(cam_params[:, :3])
    Xc = (points @ R.reshape(C * 3, 3).T).view(P, C, 3) + cam_params[:, 3:6]
    z = Xc[..., 2]
    guard = z.abs() < 1e-9
    z = torch.where(guard, torch.full_like(z, 1e-9), z)
    x = Xc[..., 0] / z
    y = Xc[..., 1] / z
    fx, sk, cx = K[0, 0], K[0, 1], K[0, 2]
    fy, cy = K[1, 1], K[1, 2]
    a = fx * x + sk * y
    r2 = x * x + y * y
    d = 1.0 + r2 * (k1 + r2 * k2)
    sd = s * d
    r = torch.stack([sd * a + cx, sd * fy * y + cy], dim=-1) - obs_uv
    if not jacobian:
        return r
    b = fy * y
    # d(u, v)/d(x, y) through the distortion, then through x = Xc0 / z and
    # y = Xc1 / z: G = d(u, v)/dXc (P, C, 2, 3).
    q = k1 + 2.0 * k2 * r2
    ddx, ddy = 2.0 * x * q, 2.0 * y * q
    pxx, pxy = s * (ddx * a + d * fx), s * (ddy * a + d * sk)
    pyx, pyy = s * (ddx * b), s * (ddy * b + d * fy)
    inv_z = 1.0 / z
    dz = torch.where(guard, torch.zeros_like(inv_z), -inv_z)
    gu = (pxx * x + pxy * y) * dz
    gv = (pyx * x + pyy * y) * dz
    G = torch.stack([
        torch.stack([pxx * inv_z, pxy * inv_z, gu], dim=-1),
        torch.stack([pyx * inv_z, pyy * inv_z, gv], dim=-1),
    ], dim=-2)
    # B = G R row by row, from R's rows (C, 3).
    R0, R1, R2 = R[:, 0], R[:, 1], R[:, 2]
    B = torch.stack([
        (pxx[..., None] * R0 + pxy[..., None] * R1) * inv_z[..., None] + gu[..., None] * R2,
        (pyx[..., None] * R0 + pyy[..., None] * R1) * inv_z[..., None] + gv[..., None] * R2,
    ], dim=-2)
    # d/dw of a row g . (R X) is (X x (g R)) J_r.
    XB = torch.linalg.cross(points[:, None, None, :].expand_as(B), B, dim=-1)
    A = torch.cat([_rows_times(XB, Jr), G], dim=-1)
    if cam_params.shape[-1] != 9 and not intr_jacobian:
        return r, A, B
    # d(u, v)/d[s, k1, k2] (for a 9-wide camera d/d ds is d/ds).
    sr2 = s * r2
    T = torch.stack([
        torch.stack([d * a, sr2 * a, sr2 * r2 * a], dim=-1),
        torch.stack([d * b, sr2 * b, sr2 * r2 * b], dim=-1),
    ], dim=-2)
    if cam_params.shape[-1] == 9:
        return r, torch.cat([A, T], dim=-1), B
    return r, A, B, T


def _res_grid(cam_params, points, obs_uv, K, intr=None):
    """Pixel residuals (P, C, 2) of every grid cell."""
    return _res_jac_grid(cam_params, points, obs_uv, K, intr, jacobian=False)


def _weights(prob: BAProblem) -> torch.Tensor:
    """(P, C) observation weights: grid mask & valid point & valid camera."""
    return (prob.obs_mask & prob.point_valid[:, None]
            & prob.cam_valid[None, :]).to(prob.points.dtype)


def _cost(prob: BAProblem, huber_delta: float = 0.0) -> torch.Tensor:
    """Mean squared pixel residual over valid observations; with
    `huber_delta` > 0 the mean Huber cost, the objective the robustified
    ``_lm_solve`` step minimizes (step and acceptance test must agree)."""
    w = _weights(prob)
    r = _res_grid(prob.cam_params, prob.points, prob.obs_uv, prob.K, prob.intr)
    sq = (r * r).sum(-1)
    if huber_delta > 0.0:
        rn = torch.sqrt(torch.clamp_min(sq, 1e-18))
        rho = torch.where(rn <= huber_delta, sq, huber_delta * (2.0 * rn - huber_delta))
    else:
        rho = sq
    return (rho * w).sum() / torch.clamp_min(w.sum(), 1.0)


# ---------------------------------------------------------------------------
# 3x3 helpers
# ---------------------------------------------------------------------------


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det); a singular block
    (|det| < 1e-20) gives zero. (..., 3, 3)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    Cc = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * Cc
    inv_det = torch.where(det.abs() < 1e-20, torch.zeros_like(det), 1.0 / det)
    adj = torch.stack([
        torch.stack([A, D, G], dim=-1),
        torch.stack([B, E, H], dim=-1),
        torch.stack([Cc, F, I], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


# ---------------------------------------------------------------------------
# One damped Gauss-Newton (LM inner) solve
# ---------------------------------------------------------------------------


def _bmv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched small matrix-vector product: (..., a, b), (..., b) -> (..., a)."""
    return (M * x[..., None, :]).sum(-1)


def _outer_sum(X: torch.Tensor, Y: torch.Tensor, dims) -> torch.Tensor:
    """sum over `dims` of X^T Y per cell: (P, C, 2, a), (P, C, 2, b) -> (..., a, b)."""
    return (X[..., :, None] * Y[..., None, :]).sum(dims)


def _lm_solve(prob: BAProblem, lam: torch.Tensor, cg_iters: int,
              huber_delta: float = 0.0, refine_intrinsics: bool = False):
    """Solve the damped normal equations via Schur + PCG.

    Width-generic in the camera block (6, or 9 with per-camera
    intrinsics). With `refine_intrinsics` the shared [s, k1, k2] block
    joins the reduced camera system: after the point blocks are eliminated
    the CG unknown is the pair (delta_cam (C, w), delta_intr (3,)), coupled
    through U_ct = sum_p A^T T, U_tt = sum T^T T and Z_p = sum_c B^T T, and
    preconditioned by U_c^-1 and U_tt^-1.

    Returns (delta_cam (C, w), delta_pts (P, 3), delta_intr (3,)).
    """
    w = _weights(prob)  # (P, C)
    if refine_intrinsics:
        r, A, B, T = _res_jac_grid(prob.cam_params, prob.points, prob.obs_uv, prob.K,
                                   prob.intr, intr_jacobian=True)
    else:
        r, A, B = _res_jac_grid(prob.cam_params, prob.points, prob.obs_uv, prob.K, prob.intr)
    if huber_delta > 0.0:
        # IRLS Huber weights min(1, delta/|r|), applied as sqrt to the
        # residuals and the Jacobians.
        rnorm = torch.linalg.norm(r, dim=-1)
        w = w * torch.sqrt(torch.clamp_max(huber_delta / torch.clamp_min(rnorm, 1e-9), 1.0))
    A = A * (w * (~prob.frozen).to(w.dtype))[..., None, None]
    B = B * w[..., None, None]
    r = r * w[..., None]
    P, C = w.shape
    nc = A.shape[-1]  # camera-block width

    U = _outer_sum(A, A, (0, 2))  # (C, nc, nc)
    V = _outer_sum(B, B, (1, 2))  # (P, 3, 3)
    # W as a (C*nc, P*3) matrix: W[(c, a), (p, b)] = (A^T B)_pc[a, b].
    At = A.permute(1, 3, 0, 2)  # (C, nc, P, 2)
    Bt = B.permute(1, 0, 3, 2)  # (C, P, 3, 2)
    W = torch.empty((C, nc, P, 3), dtype=A.dtype, device=A.device)
    torch.mul(At[..., 0, None], Bt[:, None, ..., 0], out=W)
    W = W.addcmul_(At[..., 1, None], Bt[:, None, ..., 1]).view(C * nc, P * 3)
    g_c = -(A * r[..., None]).sum((0, 2))  # (C, nc)
    g_p = -(B * r[..., None]).sum((1, 2))  # (P, 3)

    # A camera with no (unfrozen) observation has an all-zero U block
    # (its trace is the sum of its A^T A diagonal): give it the identity,
    # since its gradient is zero and a near-singular block would wreck the
    # preconditioner.
    eye_c = torch.eye(nc, dtype=U.dtype, device=U.device)
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    cam_active = U.diagonal(dim1=-2, dim2=-1).sum(-1) > 0.0
    U = U + (lam * torch.diag_embed(U.diagonal(dim1=-2, dim2=-1)) + 1e-6 * eye_c)
    V = V + (lam * torch.diag_embed(V.diagonal(dim1=-2, dim2=-1)) + 1e-6 * eye3)
    U = torch.where(cam_active[:, None, None], U, eye_c)
    V_inv = _inv3(V)
    U_inv = torch.linalg.inv_ex(U + 1e-5 * eye_c)[0]

    def Wt_dot(xc):  # (C, nc) -> (P, 3): sum_c W_pc^T x_c
        return (xc.reshape(1, C * nc) @ W).view(P, 3)

    def W_dot(xp):  # (P, 3) -> (C, nc): sum_p W_pc x_p
        return (W @ xp.reshape(P * 3, 1)).view(C, nc)

    # Schur right-hand side: b = g_c - sum_p W_pc V_p^-1 g_p.
    Vg = _bmv(V_inv, g_p)
    b = [g_c - W_dot(Vg)]
    if refine_intrinsics:
        # The shared intrinsics constrain every observation, frozen
        # cameras' included (T is not masked by `frozen`).
        T = T * w[..., None, None]
        U_ct = _outer_sum(A, T, (0, 2))  # (C, nc, 3)
        U_tt = _outer_sum(T, T, (0, 1, 2))  # (3, 3)
        Z = _outer_sum(B, T, (1, 2))  # (P, 3, 3)
        g_t = -(T * r[..., None]).sum((0, 1, 2))  # (3,)
        U_tt = U_tt + lam * torch.diag(U_tt.diagonal()) + 1e-6 * eye3
        U_tt_inv = torch.linalg.inv_ex(U_tt + 1e-5 * eye3)[0]
        b.append(g_t - (Z * Vg[:, :, None]).sum((0, 1)))

    def S_apply(x):  # matrix-free S @ x on the CG unknowns
        if not refine_intrinsics:
            return [_bmv(U, x[0]) - W_dot(_bmv(V_inv, Wt_dot(x[0])))]
        xc, xt = x
        zp = _bmv(V_inv, Wt_dot(xc) + (Z * xt).sum(-1))
        return [_bmv(U, xc) + (U_ct * xt).sum(-1) - W_dot(zp),
                (U_ct * xc[:, :, None]).sum((0, 1)) + U_tt @ xt
                - (Z * zp[:, :, None]).sum((0, 1))]

    def precond(x):  # block Jacobi: U_c^-1 per camera, U_tt^-1
        out = [_bmv(U_inv, x[0])]
        if refine_intrinsics:
            out.append(U_tt_inv @ x[1])
        return out

    def dot(a, b_):
        out = torch.vdot(a[0].reshape(-1), b_[0].reshape(-1))
        for u, v in zip(a[1:], b_[1:]):
            out = out + torch.vdot(u.reshape(-1), v.reshape(-1))
        return out

    x = [torch.zeros_like(v) for v in b]
    rr = b
    z = precond(rr)
    p = z
    zero = torch.zeros((), dtype=g_c.dtype, device=g_c.device)
    for _ in range(cg_iters):
        Sp = S_apply(p)
        denom = dot(p, Sp)
        rz = dot(rr, z)
        alpha = torch.where(denom.abs() < 1e-20, zero, rz / denom)
        x = [xi + alpha * pi for xi, pi in zip(x, p)]
        r_new = [ri + (-alpha) * si for ri, si in zip(rr, Sp)]
        z_new = precond(r_new)
        beta = torch.where(rz.abs() < 1e-20, zero, dot(r_new, z_new) / rz)
        p = [zi + beta * pi for zi, pi in zip(z_new, p)]
        rr, z = r_new, z_new

    # Back-substitute the point updates: dp = V^-1 (g_p - W^T dc - Z dt).
    acc = Wt_dot(x[0])
    if refine_intrinsics:
        acc = acc + (Z * x[1]).sum(-1)
        delta_intr = x[1]
    else:
        delta_intr = torch.zeros_like(prob.intr)
    return x[0], _bmv(V_inv, g_p - acc), delta_intr


# ---------------------------------------------------------------------------
# LM outer loop
# ---------------------------------------------------------------------------


def run_ba(prob: BAProblem, max_iterations: int = 20, cg_iters: int = 20,
           damping_init: float = 1e-3, damping_up: float = 4.0,
           damping_down: float = 2.0, huber_delta: float = 0.0,
           refine_intrinsics: bool = False):
    """Levenberg-Marquardt with accept/reject and multiplicative damping.

    Runs `max_iterations` steps without a host sync. A step is active while
    the damping is below 1e5 (where the JAX ``while_loop`` would still be
    running); only active steps update the problem, the damping and the
    counters. refine_intrinsics: also optimize the shared [s, k1, k2]
    block ``prob.intr``. Returns (BAProblem, BAStats).
    """
    cost = _cost(prob, huber_delta)
    cost0 = cost
    lam = torch.full((), damping_init, dtype=prob.points.dtype, device=prob.points.device)
    it = torch.zeros((), dtype=torch.int32, device=lam.device)
    accepted = torch.zeros_like(it)
    for _ in range(max_iterations):
        active = lam < 1e5
        dc, dp, dt = _lm_solve(prob, lam, cg_iters, huber_delta, refine_intrinsics)
        cand = prob._replace(cam_params=prob.cam_params + dc, points=prob.points + dp,
                             intr=prob.intr + dt if refine_intrinsics else prob.intr)
        new_cost = _cost(cand, huber_delta)
        improve = new_cost < cost
        take = active & improve
        prob = prob._replace(
            cam_params=torch.where(take, cand.cam_params, prob.cam_params),
            points=torch.where(take, cand.points, prob.points),
            intr=torch.where(take, cand.intr, prob.intr) if refine_intrinsics else prob.intr)
        stepped = torch.where(improve, lam / damping_down, lam * damping_up)
        lam = torch.where(active, torch.clamp(stepped, 1e-9, 1e6), lam)
        cost = torch.where(take, new_cost, cost)
        it = it + active.to(torch.int32)
        accepted = accepted + take.to(torch.int32)
    return prob, BAStats(initial_cost=cost0, final_cost=cost, iterations=it,
                         accepted=accepted)


def bundle_adjust_map(state: MapState, max_iterations: int = 20, cg_iters: int = 20,
                      frozen_first: int = 1, local_window: int = 0,
                      huber_delta: float = 0.0):
    """Map -> BA -> map. local_window > 0 = sliding local BA; huber_delta
    > 0 = robustified residuals (pixels). Returns (MapState, BAStats)."""
    prob = problem_from_map(state, frozen_first=frozen_first, local_window=local_window)
    prob, stats = run_ba(prob, max_iterations=max_iterations, cg_iters=cg_iters,
                         huber_delta=huber_delta)
    return write_back_to_map(state, prob), stats


def bundle_adjust_window(state: MapState, window_cams: int = 16,
                         window_points: int = 16384, max_iterations: int = 8,
                         cg_iters: int = 12, freeze_cams: int = 2,
                         huber_delta: float = 0.0):
    """Sliding-window local BA whose cost is independent of map capacity.

    Takes the last `window_cams` camera slots x the last `window_points`
    point slots of the grid (starts clamped into range, as
    ``lax.dynamic_slice`` does), runs the same LM on that sub-grid and
    writes the result back. The oldest `freeze_cams` window cameras are
    frozen (they anchor the window and the gauge); window points with fewer
    than 2 in-window observations are excluded and written back unchanged.
    Returns (MapState, BAStats).
    """
    C = state.poses.shape[0]
    P = state.points.shape[0]
    Wc = min(window_cams, C)
    Wp = min(window_points, P)
    dev = state.points.device
    c0 = torch.clamp(state.num_cams - Wc, 0, C - Wc)
    p0 = torch.clamp(state.num_points - Wp, 0, P - Wp)
    ci = (c0 + torch.arange(Wc, device=dev)).long()
    pi = (p0 + torch.arange(Wp, device=dev)).long()

    poses_w = state.poses[ci]
    cam_valid_w = state.cam_valid[ci]
    points_w = state.points[pi]
    point_valid_w = state.point_valid[pi]
    obs_uv_w = state.obs_uv[pi][:, ci]
    obs_mask_w = state.obs_mask[pi][:, ci]

    # Points need >= 2 observations inside the window to be determined.
    obs_w = obs_mask_w & point_valid_w[:, None] & cam_valid_w[None, :]
    point_ok = point_valid_w & (obs_w.sum(1) >= 2)
    frozen = (torch.arange(Wc, device=dev) < freeze_cams) | ~cam_valid_w

    rvec, tvec = lie.matrix_to_rt(poses_w)
    prob = BAProblem(
        cam_params=torch.cat([rvec, tvec], dim=-1), points=points_w,
        cam_valid=cam_valid_w, point_valid=point_ok, obs_uv=obs_uv_w,
        obs_mask=obs_mask_w, K=state.K, frozen=frozen,
        intr=torch.tensor(_INTR_IDENTITY, dtype=points_w.dtype, device=dev),
    )
    prob, stats = run_ba(prob, max_iterations=max_iterations, cg_iters=cg_iters,
                         huber_delta=huber_delta)
    poses_new = lie.rt_to_matrix(prob.cam_params[:, :3], prob.cam_params[:, 3:])
    poses_new = torch.where(frozen[:, None, None], poses_w, poses_new)
    points_new = torch.where(point_ok[:, None], prob.points, points_w)
    return state._replace(
        poses=state.poses.index_copy(0, ci, poses_new),
        points=state.points.index_copy(0, pi, points_new),
    ), stats


def bundle_adjust_map_percam_intrinsics(state: MapState, max_iterations: int = 20,
                                        cg_iters: int = 20, frozen_first: int = 1,
                                        huber_delta: float = 0.0):
    """Map BA with the reference notebook's full 9-parameter camera: rvec,
    t and [ds, k1, k2] per camera (focal scale s = 1 + ds relative to
    state.K). The pose block writes back into the map; the intrinsics come
    back as (C, 3) [s, k1, k2], which cannot fold into the one shared K.
    The `frozen_first` cameras keep the identity [1, 0, 0] (the gauge: a
    camera's focal trades against depth along its rays).

    Returns (state, stats, intr_percam (C, 3)).
    """
    rvec, tvec = lie.matrix_to_rt(state.poses)
    dev = state.points.device
    cam_params = torch.cat([rvec, tvec, torch.zeros_like(rvec)], dim=-1)
    prob = BAProblem(
        cam_params=cam_params, points=state.points, cam_valid=state.cam_valid,
        point_valid=state.point_valid, obs_uv=state.obs_uv, obs_mask=state.obs_mask,
        K=state.K, frozen=torch.arange(state.poses.shape[0], device=dev) < frozen_first,
        intr=torch.tensor(_INTR_IDENTITY, dtype=state.points.dtype, device=dev),
    )
    prob, stats = run_ba(prob, max_iterations=max_iterations, cg_iters=cg_iters,
                         huber_delta=huber_delta)
    intr_percam = prob.cam_params[:, 6:] + torch.tensor(
        [1.0, 0.0, 0.0], dtype=prob.cam_params.dtype, device=dev)
    return write_back_to_map(state, prob), stats, intr_percam


def bundle_adjust_map_intrinsics(state: MapState, max_iterations: int = 20,
                                 cg_iters: int = 20, frozen_first: int = 1,
                                 huber_delta: float = 0.0):
    """Map BA that also refines the shared intrinsics [s, k1, k2] (one
    physical camera took the sequence). The focal scale s is folded into
    the map's K (fx, skew, fy); the full block comes back for the caller to
    undistort with or record. Returns (state, stats, intr (3,)).
    """
    prob = problem_from_map(state, frozen_first=frozen_first)
    prob, stats = run_ba(prob, max_iterations=max_iterations, cg_iters=cg_iters,
                         huber_delta=huber_delta, refine_intrinsics=True)
    state = write_back_to_map(state, prob)
    s = prob.intr[0]
    one = torch.ones_like(s)
    scale = torch.stack([torch.stack([s, s, one]), torch.stack([one, s, one]),
                         torch.stack([one, one, one])])
    return state._replace(K=state.K * scale), stats, prob.intr
