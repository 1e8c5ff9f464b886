"""Vectorized RANSAC: one batched hypothesis-score-select engine.

PyTorch port of ``sfm_mvs_tpu/ops/ransac.py``: draw every hypothesis's
minimal sample at once, solve them as one batch, score every hypothesis
against every correspondence as one dense masked computation, and take the
argmax of the inlier counts (``torch.argmax`` returns the first maximum on
ties, as ``jnp.argmax`` does). The winner is
then refit on its inliers (E, H) or polished by Gauss-Newton (PnP).

Random samples come from a ``torch.Generator``. Every estimator also takes
optional injected sample indices (``sample_idx``...), which the parity
tests fill with the JAX package's ``_sample_indices`` output so that both
packages score the same hypotheses.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sfm_mvs_tpu_torch.ops import epipolar, five_point, homography, masking, p3p, pnp


class RansacResult(NamedTuple):
    model: torch.Tensor  # best model parameters
    inliers: torch.Tensor  # (N,) boolean inlier mask (in original order)
    num_inliers: torch.Tensor  # scalar int


def _sample_indices(gen: Optional[torch.Generator], iters: int, sample_size: int,
                    count: torch.Tensor, capacity: int) -> torch.Tensor:
    """(iters, sample_size) int64 indices uniform in [0, count).

    Sampling is i.i.d.; a collided sample yields a degenerate hypothesis,
    which loses the argmax.
    """
    u = torch.rand((iters, sample_size), generator=gen, device=count.device)
    cnt = torch.clamp_min(count, sample_size).to(u.dtype)
    idx = torch.floor(u * cnt).to(torch.int64)
    return torch.clamp(idx, 0, capacity - 1)


def ransac_essential(gen, norm0, norm1, mask, focal, threshold_px: float = 1.0,
                     iters: int = 2048, refit_rounds: int = 2, solver: str = "8pt",
                     sample_idx: Optional[torch.Tensor] = None,
                     sample_idx5: Optional[torch.Tensor] = None) -> RansacResult:
    """Essential matrix via batched minimal-solver RANSAC.

    norm0, norm1: (N, 2) K^-1-normalized correspondences; mask: (N,) valid;
    focal: pixel focal used to express Sampson distance in ~pixels.
    solver: "8pt" (8-point + manifold projection; degenerate on planar
    scenes), "5pt" (Nister, ops/five_point.py: up to 14 hypothesis slots
    per sample, each with a validity flag) or "both" (8pt's `iters` samples
    and 5pt's `iters // 4` scored as one pool; the inlier count picks the
    family that fits). sample_idx: optional (iters, 8) indices into the
    compacted correspondences for the 8-point draw, sample_idx5 the same
    ((iters, 5) for "5pt", (iters // 4, 5) for "both") for the 5-point draw;
    each replaces the generator's draw.
    """
    if solver not in ("8pt", "5pt", "both"):
        raise ValueError(f"unknown essential solver {solver!r}")
    N = norm0.shape[0]
    count, _, c0, c1 = masking.compact(mask, norm0, norm1)
    Es, hyp_valid = [], []
    if solver in ("8pt", "both"):
        if sample_idx is None:
            sample_idx = _sample_indices(gen, iters, 8, count, N)
        idx8 = sample_idx.long()
        Es.append(epipolar.essential_eight_point(c0[idx8], c1[idx8]))  # (S, 3, 3)
        hyp_valid.append(torch.ones(idx8.shape[0], dtype=torch.bool, device=norm0.device))
    if solver in ("5pt", "both"):
        if sample_idx5 is None:
            n5 = iters if solver == "5pt" else max(iters // 4, 1)
            sample_idx5 = _sample_indices(gen, n5, 5, count, N)
        idx5 = sample_idx5.long()
        E5, v5 = five_point.essential_five_point(c0[idx5], c1[idx5])  # (S, 14, 3, 3)
        Es.append(E5.reshape(-1, 3, 3))
        hyp_valid.append(v5.reshape(-1))
    Es = torch.cat(Es)
    hyp_valid = torch.cat(hyp_valid)
    residuals = epipolar.epipolar_residual_pixels(Es, norm0, norm1, focal)
    inl = (residuals < threshold_px) & mask[None, :]
    counts = inl.sum(1)
    counts = torch.where(hyp_valid, counts, torch.full_like(counts, -1))
    best = torch.argmax(counts)
    E = Es[best]
    # If every hypothesis was invalid (possible with the gated 5-point
    # solver), the argmax is arbitrary: report no inliers, so the callers'
    # rejection guards trigger, and let no refit start from the empty set.
    inliers = inl[best] & (counts[best] >= 0)

    # Inlier-weighted refits, accepted only on a strict inlier gain (a tie
    # must keep the minimal-solver E: the 8-point refit is degenerate on
    # planar inlier sets).
    for _ in range(refit_rounds):
        E2 = epipolar.essential_eight_point(norm0, norm1, inliers.to(norm0.dtype))
        res2 = epipolar.epipolar_residual_pixels(E2, norm0, norm1, focal)
        inl2 = (res2 < threshold_px) & mask
        # An empty inlier set weights every row 0: XLA's SVD of the zero
        # matrix is NaN there, so the JAX refit never wins; torch's is not.
        better = (inl2.sum() > inliers.sum()) & inliers.any()
        E = torch.where(better, E2, E)
        inliers = torch.where(better, inl2, inliers)
    return RansacResult(E, inliers, inliers.sum())


def ransac_pnp(gen, X, uv_pix, uv_norm, mask, K, threshold_px: float = 4.0,
               iters: int = 1024, refine_iters: int = 10, use_p3p: bool = True,
               sample_idx: Optional[torch.Tensor] = None,
               sample_idx3: Optional[torch.Tensor] = None) -> RansacResult:
    """Pose via batched multi-family minimal-solver RANSAC + GN polish.

    X: (N, 3) world points; uv_pix: (N, 2) pixels; uv_norm: K^-1 pixels.
    Three hypothesis families scored jointly: 6-point DLT, planar
    homography decomposition, and 3-point Grunert P3P (iters // 4 samples,
    6 pose slots each). sample_idx: optional (iters, 6) and sample_idx3:
    optional (iters // 4, 3) indices into the compacted correspondences.
    Returns model = Rt (3, 4).
    """
    N = X.shape[0]
    count, _, cX, cuvn = masking.compact(mask, X, uv_norm)
    if sample_idx is None:
        sample_idx = _sample_indices(gen, iters, 6, count, N)
    sample_idx = sample_idx.long()
    sX, suv = cX[sample_idx], cuvn[sample_idx]
    Rts = torch.cat([
        pnp.pnp_dlt(sX, suv, method="inviter"),
        pnp.pnp_planar(sX, suv, method="inviter"),
    ], dim=0)  # (2*iters, 3, 4)
    hyp_valid = torch.ones(Rts.shape[0], dtype=torch.bool, device=X.device)

    if use_p3p:
        if sample_idx3 is None:
            sample_idx3 = _sample_indices(gen, max(iters // 4, 1), 3, count, N)
        sample_idx3 = sample_idx3.long()
        Rts3, valid3 = p3p.p3p_grunert(cX[sample_idx3], cuvn[sample_idx3])
        Rts = torch.cat([Rts, Rts3.reshape(-1, 3, 4)], dim=0)
        hyp_valid = torch.cat([hyp_valid, valid3.reshape(-1)], dim=0)

    residuals = pnp.pnp_residual_pixels(Rts, X, uv_pix, K)
    inl = (residuals < threshold_px) & mask[None, :]
    counts = torch.where(hyp_valid, inl.sum(1), torch.full_like(inl.sum(1), -1))
    best = torch.argmax(counts)
    Rt = Rts[best]
    inliers = inl[best]

    # Gauss-Newton polish + reclassification, each round guarded against
    # catastrophic divergence only (a round that loses more than half the
    # previous round's consensus is rejected), as in the JAX package.
    for _ in range(2):
        Rt2 = pnp.refine_pose_gauss_newton(Rt, X, uv_pix, inliers, K, iters=refine_iters)
        res2 = pnp.pnp_residual_pixels(Rt2, X, uv_pix, K)
        inl2 = (res2 < threshold_px) & mask
        keep = inl2.sum() * 2 >= inliers.sum()
        Rt = torch.where(keep, Rt2, Rt)
        inliers = torch.where(keep, inl2, inliers)
    return RansacResult(Rt, inliers, inliers.sum())


def ransac_homography(gen, pts1, pts2, mask, threshold_px: float = 4.0,
                      iters: int = 1024, refit_rounds: int = 2,
                      sample_idx: Optional[torch.Tensor] = None) -> RansacResult:
    """Homography via batched 4-point DLT RANSAC. sample_idx: optional
    (iters, 4) indices into the compacted correspondences."""
    N = pts1.shape[0]
    count, _, c1, c2 = masking.compact(mask, pts1, pts2)
    if sample_idx is None:
        sample_idx = _sample_indices(gen, iters, 4, count, N)
    sample_idx = sample_idx.long()
    Hs = homography.homography_dlt(c1[sample_idx], c2[sample_idx], method="inviter")
    residuals = homography.transfer_error(Hs, pts1, pts2)
    inl = (residuals < threshold_px) & mask[None, :]
    best = torch.argmax(inl.sum(1))
    H = Hs[best]
    inliers = inl[best]
    for _ in range(refit_rounds):
        H = homography.homography_dlt(pts1, pts2, inliers.to(pts1.dtype))
        inliers = (homography.transfer_error(H, pts1, pts2) < threshold_px) & mask
    return RansacResult(H, inliers, inliers.sum())
