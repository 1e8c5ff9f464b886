"""Small batched linear-algebra helpers for RANSAC hypothesis solves.

PyTorch port of ``sfm_mvs_tpu/ops/linalg.py``: the null vector of a small
Gram matrix A^T A by damped inverse iteration (one Cholesky factorization
plus a few triangular solves), batched over the hypothesis dimension.

Also the port's NaN-propagating decompositions. A batch of RANSAC
hypotheses can hold degenerate samples whose matrices are not finite. XLA
decomposes those into NaN, which then loses every inlier count; torch's
CPU LAPACK path raises instead. :func:`svd` and :func:`eigh` decompose a
zeroed stand-in and return NaN for those batch entries, which keeps the
JAX package's semantics without raising.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD


def jacobian(fn, p: torch.Tensor) -> torch.Tensor:
    """Jacobian (M, P) of fn: (P,) -> (M,) by forward-mode AD, one dual pass
    per parameter (``jax.jacfwd``'s counterpart for the small pose
    parameterizations of the Gauss-Newton polishes).

    Plain dual tensors rather than ``torch.func.jacfwd``: under its vmap, a
    0-dim tensor combined with a Python float promotes the tangent to
    float64, which breaks the float32 solves.
    """
    cols = []
    with fwAD.dual_level():
        for k in range(p.shape[0]):
            tangent = torch.zeros_like(p)
            tangent[k] = 1.0
            cols.append(fwAD.unpack_dual(fn(fwAD.make_dual(p, tangent))).tangent)
    return torch.stack(cols, dim=-1)


def _nonfinite_rows(A: torch.Tensor):
    bad = ~torch.isfinite(A).all(-1).all(-1)
    return bad, torch.where(bad[..., None, None], torch.zeros_like(A), A)


def _poison(x: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    bad = bad.reshape(bad.shape + (1,) * (x.dim() - bad.dim()))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def svd(A: torch.Tensor, full_matrices: bool = True):
    """torch.linalg.svd that returns NaN factors for non-finite matrices."""
    bad, A0 = _nonfinite_rows(A)
    U, S, Vt = torch.linalg.svd(A0, full_matrices=full_matrices)
    return _poison(U, bad), _poison(S, bad), _poison(Vt, bad)


def svdvals(A: torch.Tensor) -> torch.Tensor:
    bad, A0 = _nonfinite_rows(A)
    return _poison(torch.linalg.svdvals(A0), bad)


def eigh(A: torch.Tensor):
    """torch.linalg.eigh that returns NaN for non-finite matrices."""
    bad, A0 = _nonfinite_rows(A)
    w, V = torch.linalg.eigh(A0)
    return _poison(w, bad), _poison(V, bad)


def solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.linalg.solve without the singular-matrix error (XLA returns
    inf/NaN there; the callers' guards reject such steps)."""
    return torch.linalg.solve_ex(A, b)[0]


def smallest_eigvec(G: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of a PSD matrix.

    G: (..., D, D) symmetric positive semi-definite Gram matrix whose
    smallest eigenvalue is ~0. Returns (..., D).

    Factor G + lam*I once (lam = 1e-5 * mean diagonal), then solve and
    normalize `iters` times from two deterministic start vectors (all ones,
    and alternating signs) and keep the one with the smaller Rayleigh
    quotient z^T G z.
    """
    D = G.shape[-1]
    eye = torch.eye(D, dtype=G.dtype, device=G.device)
    lam = 1e-5 * (torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / D)[..., None, None]
    # cholesky_ex: a non-PD (degenerate) hypothesis gives garbage that
    # loses the RANSAC argmax, as in the JAX package, instead of raising.
    L = torch.linalg.cholesky_ex(G + lam * eye)[0]

    def iterate(z):
        for _ in range(iters):
            z = torch.cholesky_solve(z[..., None], L)[..., 0]
            z = z / torch.clamp_min(torch.linalg.norm(z, dim=-1, keepdim=True), 1e-30)
        return z

    ones = torch.ones(G.shape[:-2] + (D,), dtype=G.dtype, device=G.device)
    alt = torch.where(torch.arange(D, device=G.device) % 2 == 0, 1.0, -1.0).to(G.dtype)
    alt = alt.expand(G.shape[:-2] + (D,))
    za = iterate(ones)
    zb = iterate(alt)
    ray_a = torch.einsum("...i,...ij,...j->...", za, G, za)
    ray_b = torch.einsum("...i,...ij,...j->...", zb, G, zb)
    return torch.where((ray_a <= ray_b)[..., None], za, zb)
