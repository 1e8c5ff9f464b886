"""Shared helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

The same numpy inputs go through a JAX function of ``sfm_mvs_tpu`` and its
counterpart in ``sfm_mvs_tpu_torch``; these helpers move data between the
two as numpy arrays. One torch thread per test process: tier-1 runs several
pytest workers on a small machine.
"""

from __future__ import annotations

import numpy as np
import torch

import sfm_mvs_tpu_torch  # noqa: F401  (full-fp32 matmul flags)

torch.set_num_threads(1)


def T(a, dtype=None) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (a copy)."""
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def J(a):
    """numpy / torch array -> jax array."""
    import jax.numpy as jnp

    return jnp.asarray(N(a))


def N(a) -> np.ndarray:
    """jax array / torch tensor / numpy -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_close(ours, ref, rtol=1e-4, atol=1e-5, err_msg=""):
    np.testing.assert_allclose(N(ours), N(ref), rtol=rtol, atol=atol, err_msg=err_msg)


def rotation_angle_deg(R1, R2) -> float:
    """Angle of R1 R2^T in degrees, as atan2(sin, cos) in float64: the
    arccos of the trace alone cannot resolve angles below ~0.03 deg for
    float32 rotations, whose orthonormality error is ~1e-7."""
    dR = N(R1).astype(np.float64) @ N(R2).astype(np.float64).T
    w = 0.5 * np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    c = (np.trace(dR) - 1.0) / 2.0
    return float(np.degrees(np.arctan2(np.linalg.norm(w), c)))


def random_rotation(rng, max_angle=1.0) -> np.ndarray:
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(0.05, max_angle)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * Kx @ Kx).astype(np.float32)


def camera_scene(rng, n=200, noise_px=0.3, outlier_frac=0.3, planar=False):
    """World points in front of two cameras, with pixel noise and outliers.

    Returns dict(K, X, R, t, uv0, uv1, inlier) — uv0 seen by [I|0], uv1 by
    [R|t]; outliers displaced by 20-80 px in uv1.
    """
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    X = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    X[:, 2] = (0.3 * X[:, 0] if planar else X[:, 2]) + 8.0
    R = random_rotation(rng, 0.2)
    t = np.array([1.0, -0.2, 0.3], np.float32)

    def proj(Xw, R_, t_):
        h = (Xw @ R_.T + t_) @ K.T
        return (h[:, :2] / h[:, 2:]).astype(np.float32)

    uv0 = proj(X, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    uv1 = proj(X, R, t)
    uv0 += rng.normal(0, noise_px, uv0.shape).astype(np.float32)
    uv1 += rng.normal(0, noise_px, uv1.shape).astype(np.float32)
    out = rng.random(n) < outlier_frac
    disp = rng.uniform(20, 80, (n, 2)) * rng.choice([-1, 1], (n, 2))
    uv1[out] += disp[out].astype(np.float32)
    return dict(K=K, X=X, R=R, t=t, uv0=uv0, uv1=uv1, inlier=~out)


def normalize(uv, K) -> np.ndarray:
    return ((uv - K[[0, 1], [2, 2]]) / K[[0, 1], [0, 1]]).astype(np.float32)
