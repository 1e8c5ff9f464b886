"""SO(3) / SE(3) Lie-group operations: closed-form axis-angle exp/log maps.

PyTorch port of ``sfm_mvs_tpu/ops/lie.py``. Branch-free (``torch.where``
with Taylor fallbacks near theta=0, and the symmetric-part axis near
theta=pi), batched over any leading dimensions.
"""

from __future__ import annotations

import math

import torch

from sfm_mvs_tpu_torch.ops import linalg

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x from a 3-vector. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) skew matrix -> (..., 3) vector."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle rotation vector -> rotation matrix (Rodrigues formula).

    w: (..., 3). Returns (..., 3, 3), with 2nd-order Taylor expansions of
    sin(t)/t and (1-cos(t))/t^2 below _EPS.
    """
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle vector. R: (..., 3, 3) -> (..., 3).

    Valid on all of SO(3), including theta = pi: near pi the axis comes
    from the symmetric part R + I ~ 2 n n^T (its dominant column), with the
    sign aligned to the antisymmetric part while that still carries it.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = vee(R - R.transpose(-1, -2)) * 0.5  # = sin(theta) * axis
    sin_theta = torch.sin(theta)
    small = theta < 1e-4
    scale = torch.where(
        small,
        1.0 + theta * theta / 6.0,
        theta / torch.where(small, torch.ones_like(sin_theta), sin_theta + _EPS),
    )
    v_std = w * scale[..., None]

    # theta ~ pi: axis^2 from the dominant column of S = R + I (~ 2nn^T).
    S = R + torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    col_norm2 = (S * S).sum(-2)  # (..., 3)
    j = torch.argmax(col_norm2, dim=-1)
    onehot = torch.nn.functional.one_hot(j, 3).to(R.dtype)  # (..., 3)
    n = (S * onehot[..., None, :]).sum(-1)  # column j of S
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), _EPS)
    sgn = torch.where((n * w).sum(-1) < 0.0, -1.0, 1.0)
    v_pi = theta[..., None] * n * sgn[..., None]

    near_pi = theta > (math.pi - 1e-2)
    return torch.where(near_pi[..., None], v_pi, v_std)


def rt_to_matrix(rvec: torch.Tensor, tvec: torch.Tensor) -> torch.Tensor:
    """(rvec (...,3), tvec (...,3)) -> [R|t] (..., 3, 4)."""
    return torch.cat([so3_exp(rvec), tvec[..., :, None]], dim=-1)


def matrix_to_rt(Rt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[R|t] (..., 3, 4) -> (rvec (...,3), tvec (...,3))."""
    return so3_log(Rt[..., :3, :3]), Rt[..., :3, 3]


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project an approximate rotation onto SO(3) via SVD (det +1)."""
    U, _, Vt = linalg.svd(R)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (U * D[..., None, :]) @ Vt
