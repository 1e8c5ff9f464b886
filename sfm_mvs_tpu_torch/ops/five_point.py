"""Nister 5-point minimal essential-matrix solver, batched over samples.

PyTorch port of ``sfm_mvs_tpu/ops/five_point.py`` (Nister, "An efficient
solution to the five-point relative pose problem", PAMI 2004): the null
space of the 5x9 epipolar design matrix, the ten cubic constraints on
E = x E1 + y E2 + z E3 + E4, Gauss-Jordan elimination (one batched 10x10
solve), the degree-10 polynomial det(B(z)), its real roots by sign changes
on a tan-spaced grid plus bisection and guarded Newton steps, (x, y) by
least squares, a Gauss-Newton polish of every (x, y, z) on the ten
cubics, a residual gate, and the projection onto the essential manifold.

Every step runs on the leading sample axis S at once, so the count of
device ops does not grow with S. Where the JAX package expands the cubic
constraints into per-monomial scalars at trace time, the port keeps each
polynomial as a dense coefficient vector over a fixed monomial basis and
multiplies two of them with one product against a constant 0/1 table.

The solver is split in two (:func:`null_basis`, :func:`essential_from_basis`)
because the null-space basis of a 5x9 matrix is not unique: LAPACK, cuSOLVER
and XLA may return different bases that span the same space, and with them
a different degree-10 polynomial with the same solution set. The parity
tests feed the JAX package's basis into the second stage.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sfm_mvs_tpu_torch.ops import linalg
from sfm_mvs_tpu_torch.ops.p3p import _conv, _polyval

Monomial = tuple[int, int, int]  # exponents of (x, y, z)

# Nister's monomial order for the 10x20 constraint matrix: the first 10
# columns are eliminated by Gauss-Jordan, the trailing 10 survive into the
# B(z) determinant. Together they are every monomial of degree <= 3.
_LEAD: list[Monomial] = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
]
_TAIL: list[Monomial] = [
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_CUBIC = _LEAD + _TAIL
_LINEAR: list[Monomial] = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # x, y, z, 1
_QUADRATIC: list[Monomial] = sorted(
    {(a[0] + b[0], a[1] + b[1], a[2] + b[2]) for a in _LINEAR for b in _LINEAR})

N_ROOT_SLOTS = 14  # 10 sign-change brackets + 4 local-minimum candidates


def _product_table(basis_a, basis_b, basis_out, like: torch.Tensor) -> torch.Tensor:
    """(len(a) * len(b), len(out)) 0/1 table: row (i, j) marks the monomial
    basis_a[i] * basis_b[j] in basis_out."""
    pos = {m: k for k, m in enumerate(basis_out)}
    T = np.zeros((len(basis_a) * len(basis_b), len(basis_out)), np.float32)
    for i, a in enumerate(basis_a):
        for j, b in enumerate(basis_b):
            T[i * len(basis_b) + j, pos[(a[0] + b[0], a[1] + b[1], a[2] + b[2])]] = 1.0
    return torch.as_tensor(T, dtype=like.dtype, device=like.device)


def _pmul(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Product of polynomials given as coefficient vectors (..., na), (..., nb)."""
    outer = a[..., :, None] * b[..., None, :]
    return outer.reshape(outer.shape[:-2] + (-1,)) @ table


def _constraint_matrix(E1, E2, E3, E4) -> torch.Tensor:
    """(S, 10, 20) coefficients of Nister's cubic constraints over _CUBIC.

    E(x, y, z) = x E1 + y E2 + z E3 + E4. The ten cubics are det(E) = 0 and
    the nine entries of 2 E E^T E - tr(E E^T) E = 0.
    """
    E = torch.stack([E1, E2, E3, E4], dim=-1)  # (S, 3, 3, 4) linear entries
    t11 = _product_table(_LINEAR, _LINEAR, _QUADRATIC, E)
    t21 = _product_table(_QUADRATIC, _LINEAR, _CUBIC, E)
    # E E^T: entry (i, j) = sum_k E[i, k] E[j, k], quadratic.
    EEt = _pmul(E[:, :, None, :, :], E[:, None, :, :, :], t11).sum(-2)  # (S, 3, 3, 10)
    tr = EEt[:, 0, 0] + EEt[:, 1, 1] + EEt[:, 2, 2]  # (S, 10)
    # (E E^T) E: entry (i, j) = sum_k EEt[i, k] E[k, j], cubic.
    EEtE = _pmul(EEt[:, :, None, :, :], E.transpose(1, 2)[:, None, :, :, :], t21).sum(-2)
    trace_terms = 2.0 * EEtE - _pmul(tr[:, None, None, :], E, t21)  # (S, 3, 3, 20)

    def minor(i0, j0, i1, j1):  # E[1, j0] E[2, j1] - E[1, j1] E[2, j0], quadratic
        return _pmul(E[:, i0, j0], E[:, i1, j1], t11) - _pmul(E[:, i0, j1], E[:, i1, j0], t11)

    det = (_pmul(minor(1, 1, 2, 2), E[:, 0, 0], t21)
           - _pmul(minor(1, 0, 2, 2), E[:, 0, 1], t21)
           + _pmul(minor(1, 0, 2, 1), E[:, 0, 2], t21))
    return torch.cat([det[:, None], trace_terms.reshape(-1, 9, 20)], dim=1)


# ---------------------------------------------------------------------------
# Degree-10 real-root extraction (fixed shape)
# ---------------------------------------------------------------------------


def _safe_eval(c: torch.Tensor, c_rev: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """n(z) up to a positive factor, overflow-free: for |z| > 1 the reversed
    polynomial at 1/z (n(z) = z^10 n_rev(1/z), z^10 >= 0)."""
    inner = z.abs() <= 1.0
    zi = torch.where(inner, z, 1.0 / torch.where(z == 0, torch.ones_like(z), z))
    return torch.where(inner, _polyval(c, zi), _polyval(c_rev, zi))


def real_roots_deg10(coeffs: torch.Tensor, grid: int = 1024, bisect_iters: int = 40,
                     newton_iters: int = 3):
    """Real-root candidates of degree-10 polynomials (coeffs (..., 11),
    highest degree first).

    Returns (roots (..., 14), valid (..., 14) bool). Slots 0..9 come from
    sign changes on a tan-spaced grid over (-inf, inf), bisected and then
    polished by guarded Newton steps (in 1/z for |z| > 1); slots 10..13 are
    the grid points of the four deepest local minima of |n| that are not
    sign changes (near-double roots whose crossing is lost to float32
    noise). Callers validate every candidate against the original equations.
    """
    batch = coeffs.shape[:-1]
    coeffs = coeffs.reshape(-1, 11)
    dtype, dev = coeffs.dtype, coeffs.device
    scale = torch.clamp_min(coeffs.abs().amax(-1, keepdim=True), 1e-30)
    c = coeffs / scale
    c_rev = c.flip(-1)

    theta = torch.linspace(-math.pi / 2 + 1e-3, math.pi / 2 - 1e-3, grid, dtype=dtype,
                           device=dev)
    zs = torch.tan(theta)
    vals = _safe_eval(c, c_rev, zs.expand(c.shape[0], grid))
    signs = torch.sign(vals)
    flips = signs[:, :-1] * signs[:, 1:] < 0  # (S, grid - 1)

    # The first 10 brackets; empty slots point past the end.
    ar = torch.arange(grid - 1, device=dev)
    idx = torch.sort(torch.where(flips, ar, torch.full_like(ar, grid)), dim=-1).values[:, :10]
    valid = idx < grid
    idx = torch.clamp_max(idx, grid - 2)

    mag = vals.abs()
    locmin = (mag[:, 1:-1] <= mag[:, :-2]) & (mag[:, 1:-1] <= mag[:, 2:])
    near_flip = flips[:, :-1] | flips[:, 1:]
    cand_mag = torch.where(locmin & ~near_flip, mag[:, 1:-1],
                           torch.full_like(mag[:, 1:-1], math.inf))
    # The four smallest, the lowest index first on ties (lax.top_k's order).
    cand_pos = torch.sort(cand_mag, dim=-1, stable=True).indices[:, :4]
    extra_z = zs[cand_pos + 1]
    extra_valid = torch.isfinite(torch.gather(cand_mag, -1, cand_pos))

    lo, hi = zs[idx], zs[idx + 1]
    slo = torch.sign(_safe_eval(c, c_rev, lo))
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        smid = torch.sign(_safe_eval(c, c_rev, mid))
        go_left = slo * smid < 0
        lo, hi, slo = (torch.where(go_left, lo, mid), torch.where(go_left, mid, hi),
                       torch.where(go_left, slo, smid))
    z = 0.5 * (lo + hi)

    powers = torch.arange(10, 0, -1, dtype=dtype, device=dev)
    dc, dc_rev = c[:, :-1] * powers, c_rev[:, :-1] * powers
    for _ in range(newton_iters):
        inner = z.abs() <= 1.0
        u = torch.where(inner, z, 1.0 / torch.where(z == 0, torch.ones_like(z), z))
        f = torch.where(inner, _polyval(c, u), _polyval(c_rev, u))
        df = torch.where(inner, _polyval(dc, u), _polyval(dc_rev, u))
        step = f / torch.where(df.abs() < 1e-20, torch.full_like(df, 1e-20), df)
        u2 = u - torch.clamp(step, -0.1, 0.1)  # stay inside the bracket's basin
        z = torch.where(inner, u2, 1.0 / torch.where(u2 == 0, torch.full_like(u2, 1e-20), u2))
    roots = torch.cat([z, extra_z], dim=-1)
    ok = torch.cat([valid, extra_valid], dim=-1)
    return roots.reshape(batch + (N_ROOT_SLOTS,)), ok.reshape(batch + (N_ROOT_SLOTS,))


# ---------------------------------------------------------------------------
# The minimal solver
# ---------------------------------------------------------------------------


def null_basis(pts1: torch.Tensor, pts2: torch.Tensor):
    """(E1, E2, E3, E4), each (S, 3, 3): the last four right singular vectors
    of the (S, 5, 9) epipolar design matrix of normalized points (S, 5, 2)."""
    x1, y1 = pts1[..., 0], pts1[..., 1]
    x2, y2 = pts2[..., 0], pts2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    Vt = linalg.svd(A, full_matrices=True)[2]  # (S, 9, 9)
    return tuple(Vt[:, k].reshape(-1, 3, 3) for k in (5, 6, 7, 8))


def _monomials(p: torch.Tensor):
    """Values (..., 20) of _CUBIC at p = (..., 3) and their derivatives
    (..., 20, 3) in (x, y, z)."""
    one = torch.ones_like(p[..., 0])
    zero = torch.zeros_like(one)
    pw = [[one, p[..., a], p[..., a] * p[..., a], p[..., a] * p[..., a] * p[..., a]]
          for a in range(3)]
    mono, grad = [], []
    for e in _CUBIC:
        mono.append(pw[0][e[0]] * pw[1][e[1]] * pw[2][e[2]])
        d = []
        for a in range(3):
            if e[a] == 0:
                d.append(zero)
                continue
            rest = [pw[b][e[b]] for b in range(3) if b != a]
            d.append(e[a] * pw[a][e[a] - 1] * rest[0] * rest[1])
        grad.append(torch.stack(d, dim=-1))
    return torch.stack(mono, dim=-1), torch.stack(grad, dim=-2)


def essential_from_basis(E1, E2, E3, E4):
    """All essential matrices x E1 + y E2 + z E3 + E4 of (S, 3, 3) bases.

    Returns (Es (S, 14, 3, 3), valid (S, 14) bool): up to 10 real
    solutions plus recovered near-double roots, each projected onto the
    essential manifold; invalid slots hold garbage (or NaN) and must be
    masked. Validity is gated on the normalized constraint residual after
    the polish, so duplicate slots may carry the same solution.
    """
    dtype, dev = E4.dtype, E4.device
    M = _constraint_matrix(E1, E2, E3, E4)  # (S, 10, 20)
    M = M / torch.clamp_min(torch.linalg.norm(M, dim=-1, keepdim=True), 1e-30)
    X = linalg.solve(M[:, :, :10], M[:, :, 10:])  # Gauss-Jordan: [I | X]

    # <k> = <e> - z<f>, <l> = <g> - z<h>, <m> = <i> - z<j>: coefficient
    # polynomials (highest degree first) of x, y and 1. Tail columns:
    # [xz^2, xz, x, yz^2, yz, y, z^3, z^2, z, 1].
    def rows(a, b):
        ra, rb = X[:, a], X[:, b]
        px = torch.stack([-rb[:, 0], ra[:, 0] - rb[:, 1], ra[:, 1] - rb[:, 2], ra[:, 2]], -1)
        py = torch.stack([-rb[:, 3], ra[:, 3] - rb[:, 4], ra[:, 4] - rb[:, 5], ra[:, 5]], -1)
        pc = torch.stack([-rb[:, 6], ra[:, 6] - rb[:, 7], ra[:, 7] - rb[:, 8],
                          ra[:, 8] - rb[:, 9], ra[:, 9]], -1)
        return px, py, pc

    kx, ky, kc = rows(4, 5)
    lx, ly, lc = rows(6, 7)
    mx, my, mc = rows(8, 9)
    # det(B(z)): degree 10, 11 coefficients, highest first.
    n = (_conv(kx, _conv(ly, mc) - _conv(lc, my))
         - _conv(ky, _conv(lx, mc) - _conv(lc, mx))
         + _conv(kc, _conv(lx, my) - _conv(ly, mx)))
    zr, valid = real_roots_deg10(n)  # (S, 14)

    # (x, y) per root: least squares on B(z) [x, y, 1]^T = 0.
    B = torch.stack([
        torch.stack([_polyval(kx, zr), _polyval(ky, zr), _polyval(kc, zr)], -1),
        torch.stack([_polyval(lx, zr), _polyval(ly, zr), _polyval(lc, zr)], -1),
        torch.stack([_polyval(mx, zr), _polyval(my, zr), _polyval(mc, zr)], -1),
    ], dim=-2)  # (S, 14, 3, 3)
    Bxy = B[..., :2]
    G = Bxy.transpose(-1, -2) @ Bxy + 1e-20 * torch.eye(2, dtype=dtype, device=dev)
    xy = linalg.solve(G, (Bxy.transpose(-1, -2) @ -B[..., 2:])).squeeze(-1)
    p = torch.cat([xy, zr[..., None]], dim=-1)  # (S, 14, 3)

    # Gauss-Newton polish of each (x, y, z) on the 10 cubics (10 residuals,
    # 3 unknowns), the Jacobian in closed form; a step is kept only where
    # it lowers the residual.
    Mt = M.transpose(-1, -2)[:, None]  # (S, 1, 20, 10)

    def constraints(q):
        mono, grad = _monomials(q)
        return (mono[..., None, :] @ Mt)[..., 0, :], grad

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    r, grad = constraints(p)
    for _ in range(6):
        J = M[:, None] @ grad  # (S, 14, 10, 3)
        Jt = J.transpose(-1, -2)
        cand = p - linalg.solve(Jt @ J + 1e-12 * eye3, Jt @ r[..., None])[..., 0]
        r_c, grad_c = constraints(cand)
        better = ((r_c * r_c).sum(-1) < (r * r).sum(-1))[..., None]
        p = torch.where(better, cand, p)
        r = torch.where(better, r_c, r)
        grad = torch.where(better[..., None], grad_c, grad)

    # Gate on the constraint residual normalized by the monomial magnitude.
    mono_norm = (1.0 + (p * p).sum(-1)) ** 1.5
    valid = valid & (torch.linalg.norm(r, dim=-1) / mono_norm < 1e-4)

    x, y, z = p[..., 0, None, None], p[..., 1, None, None], p[..., 2, None, None]
    Es = x * E1[:, None] + y * E2[:, None] + z * E3[:, None] + E4[:, None]
    U, _, Vh = linalg.svd(Es)
    diag = torch.tensor([1.0, 1.0, 0.0], dtype=dtype, device=dev)
    return (U * diag) @ Vh, valid


def essential_five_point(pts1: torch.Tensor, pts2: torch.Tensor):
    """All essential matrices consistent with 5 correspondences.

    pts1, pts2: (S, 5, 2) *normalized camera* coordinates (K^-1 pixels),
    one minimal sample per row. Returns (Es (S, 14, 3, 3), valid (S, 14)).
    """
    return essential_from_basis(*null_basis(pts1, pts2))
