"""Perspective-3-Point minimal solver (Grunert quartic form).

PyTorch port of ``sfm_mvs_tpu/ops/p3p.py``, batched over samples. With
depths d_i along unit bearings f_i and inter-point distances a, b, c, the
substitutions u = d2/d1, v = d3/d1 leave a quartic in v; its positive real
roots are bracketed on a fixed tan-spaced grid and refined by bisection
and Newton, every slot carrying a validity flag. Each root gives depths
(polished by Gauss-Newton on the law-of-cosines system) and the pose by
3-point rigid alignment (Kabsch).
"""

from __future__ import annotations

import math

import torch

from sfm_mvs_tpu_torch.ops import linalg

def _polyval(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Horner evaluation. coeffs (..., n) highest first; z (..., m)."""
    acc = torch.zeros_like(z) + coeffs[..., 0, None]
    for k in range(1, coeffs.shape[-1]):
        acc = acc * z + coeffs[..., k, None]
    return acc


def _conv(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Full 1-D convolution (polynomial product) of (..., n) and (..., m)."""
    n, m = p1.shape[-1], p2.shape[-1]
    out = [0.0] * (n + m - 1)
    for i in range(n):
        for j in range(m):
            out[i + j] = out[i + j] + p1[..., i] * p2[..., j]
    return torch.stack(out, dim=-1)


def _real_roots_quartic_pos(coeffs: torch.Tensor, grid: int = 256,
                            bisect_iters: int = 30, newton_iters: int = 2):
    """Positive real-root candidates of quartics (coeffs (S, 5), highest
    first). Returns (roots (S, 6), valid (S, 6)); slots 4..5 are the two
    deepest non-crossing local minima of |p| (near-double roots)."""
    dtype, dev = coeffs.dtype, coeffs.device
    scale = torch.clamp_min(coeffs.abs().amax(-1, keepdim=True), 1e-30)
    c = coeffs / scale
    c_rev = c.flip(-1)

    theta = torch.linspace(1e-3, math.pi / 2 - 1e-3, grid, dtype=dtype, device=dev)
    zs = torch.tan(theta)

    def safe_eval(z):
        # For z > 1 use the reversed polynomial at 1/z (p(z) = z^4 p_rev(1/z)).
        inner = z <= 1.0
        zi = torch.where(inner, z, 1.0 / torch.clamp_min(z, 1e-30))
        return torch.where(inner, _polyval(c, zi), _polyval(c_rev, zi))

    S = c.shape[0]
    vals = safe_eval(zs.expand(S, grid))
    signs = torch.sign(vals)
    flips = signs[:, :-1] * signs[:, 1:] < 0  # (S, G-1)

    ar = torch.arange(grid - 1, device=dev)
    idx = torch.where(flips, ar, torch.full_like(ar, grid))
    idx = torch.sort(idx, dim=-1).values[:, :4]
    valid = idx < grid
    idx = torch.clamp_max(idx, grid - 2)

    mag = vals.abs()
    locmin = (mag[:, 1:-1] <= mag[:, :-2]) & (mag[:, 1:-1] <= mag[:, 2:])
    near_flip = flips[:, :-1] | flips[:, 1:]
    cand_mag = torch.where(locmin & ~near_flip, mag[:, 1:-1],
                           torch.full_like(mag[:, 1:-1], math.inf))
    # The two smallest, lowest index first on ties: lax.top_k's order.
    cand_pos = torch.sort(cand_mag, dim=-1, stable=True).indices[:, :2]
    extra_z = zs[cand_pos + 1]
    extra_valid = torch.isfinite(torch.gather(cand_mag, -1, cand_pos))

    lo = zs[idx]
    hi = zs[idx + 1]
    slo = torch.sign(safe_eval(lo))
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        smid = torch.sign(safe_eval(mid))
        go_left = slo * smid < 0
        lo, hi, slo = (torch.where(go_left, lo, mid), torch.where(go_left, mid, hi),
                       torch.where(go_left, slo, smid))
    z = 0.5 * (lo + hi)

    dc = c[:, :-1] * torch.arange(4, 0, -1, dtype=dtype, device=dev)
    for _ in range(newton_iters):
        f = _polyval(c, z)
        df = _polyval(dc, z)
        step = f / torch.where(df.abs() < 1e-20, torch.full_like(df, 1e-20), df)
        z = z - torch.clamp(step, -0.05, 0.05)
    return torch.cat([z, extra_z], dim=-1), torch.cat([valid, extra_valid], dim=-1)


def _kabsch(Xw: torch.Tensor, Yc: torch.Tensor):
    """Exact rigid alignment Y ~= R X + t for 3-point triads (..., 3, 3)."""
    cX = Xw.mean(-2, keepdim=True)
    cY = Yc.mean(-2, keepdim=True)
    H = (Xw - cX).transpose(-1, -2) @ (Yc - cY)
    U, _, Vt = linalg.svd(H)
    V = Vt.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ U.transpose(-1, -2)))
    ones = torch.ones_like(d)
    S = torch.diag_embed(torch.stack([ones, ones, d], dim=-1))
    R = V @ S @ U.transpose(-1, -2)
    t = cY[..., 0, :] - (R @ cX[..., 0, :, None])[..., 0]
    return R, t


def p3p_grunert(X: torch.Tensor, uv_norm: torch.Tensor):
    """Up to 4 poses from 3 world points + 3 normalized image points.

    X: (S, 3, 3) world points; uv_norm: (S, 3, 2) K^-1-normalized pixels.
    Returns (Rts (S, 6, 3, 4), valid (S, 6) bool); invalid slots (degenerate
    samples, spurious roots) hold [I|0] and are flagged.
    """
    dtype, dev = X.dtype, X.device
    f = torch.cat([uv_norm, torch.ones_like(uv_norm[..., :1])], dim=-1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)  # unit bearings

    a2 = ((X[:, 1] - X[:, 2]) ** 2).sum(-1)
    b2 = ((X[:, 0] - X[:, 2]) ** 2).sum(-1)
    c2 = ((X[:, 0] - X[:, 1]) ** 2).sum(-1)
    cos_a = (f[:, 1] * f[:, 2]).sum(-1)
    cos_b = (f[:, 0] * f[:, 2]).sum(-1)
    cos_g = (f[:, 0] * f[:, 1]).sum(-1)

    b2s = torch.clamp_min(b2, 1e-20)
    r = (a2 - c2) / b2s
    q = c2 / b2s

    # u = N(v) / D(v); the third law-of-cosines ratio then gives the
    # quartic N^2 - 2 cos(gamma) N D + G D^2 = 0.
    Nc = torch.stack([r - 1.0, -2.0 * r * cos_b, 1.0 + r], dim=-1)
    Dc = torch.stack([-2.0 * cos_a, 2.0 * cos_g], dim=-1)
    Gc = torch.stack([-q, 2.0 * q * cos_b, 1.0 - q], dim=-1)
    ND = _conv(Nc, Dc)
    quart = _conv(Nc, Nc)
    quart = quart - 2.0 * cos_g[:, None] * torch.cat([torch.zeros_like(ND[:, :1]), ND], dim=-1)
    quart = quart + _conv(Gc, _conv(Dc, Dc))

    v, valid = _real_roots_quartic_pos(quart)  # (S, 6)

    Nv = _polyval(Nc, v)
    Dv = _polyval(Dc, v)
    ok_d = Dv.abs() > 1e-9
    u = Nv / torch.where(ok_d, Dv, torch.ones_like(Dv))
    cb = cos_b[:, None]
    denom = 1.0 + v * v - 2.0 * v * cb
    ok_den = denom > 1e-12
    d1 = torch.sqrt(b2[:, None] / torch.where(ok_den, denom, torch.ones_like(denom)))
    d = torch.stack([d1, u * d1, v * d1], dim=-1)  # (S, 6, 3)

    # Gauss-Newton on the three law-of-cosines equations (exact system;
    # the quartic root carries float32 elimination noise).
    ca, cg = cos_a[:, None], cos_g[:, None]
    A2, B2, C2 = a2[:, None], b2[:, None], c2[:, None]
    eye = torch.eye(3, dtype=dtype, device=dev)
    for _ in range(3):
        e1, e2, e3 = d[..., 0], d[..., 1], d[..., 2]
        g = torch.stack([
            e2 * e2 + e3 * e3 - 2 * e2 * e3 * ca - A2,
            e1 * e1 + e3 * e3 - 2 * e1 * e3 * cb - B2,
            e1 * e1 + e2 * e2 - 2 * e1 * e2 * cg - C2,
        ], dim=-1)
        z = torch.zeros_like(e1)
        J = 2.0 * torch.stack([
            torch.stack([z, e2 - e3 * ca, e3 - e2 * ca], dim=-1),
            torch.stack([e1 - e3 * cb, z, e3 - e1 * cb], dim=-1),
            torch.stack([e1 - e2 * cg, e2 - e1 * cg, z], dim=-1),
        ], dim=-2)
        Jt = J.transpose(-1, -2)
        JtJ = Jt @ J + 1e-9 * eye
        d = d - linalg.solve(JtJ, (Jt @ g[..., None])[..., 0])
    ok_depth = (d > 0).all(-1)
    Yc = d[..., None] * f[:, None]  # (S, 6, 3, 3)
    R, t = _kabsch(X[:, None].expand_as(Yc), Yc)
    Rt = torch.cat([R, t[..., None]], dim=-1)
    ok = ok_d & ok_den & ok_depth & torch.isfinite(Rt).all(-1).all(-1)
    ident = torch.eye(3, 4, dtype=dtype, device=dev)
    return torch.where(ok[..., None, None], Rt, ident), valid & ok
