"""Two-view bootstrap: the reconstruction's initialization.

PyTorch port of ``sfm_mvs_tpu/models/two_view.py``: match features ->
essential-matrix RANSAC -> pose recovery (SVD + cheirality), with H/E model
selection for near-planar pairs -> Gauss-Newton polish of the relative
pose -> DLT triangulation -> reprojection audit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sfm_mvs_tpu_torch.ops import epipolar, matching, projection, ransac, triangulation
from sfm_mvs_tpu_torch.ops.sift import Features
from sfm_mvs_tpu_torch.utils.config import SfmConfig


class TwoViewResult(NamedTuple):
    pose0: torch.Tensor  # (3, 4) world->cam0 (identity by convention)
    pose1: torch.Tensor  # (3, 4) world->cam1
    points: torch.Tensor  # (M, 3) triangulated points (M = match capacity)
    uv0: torch.Tensor  # (M, 2) pixel obs in image 0
    uv1: torch.Tensor  # (M, 2) pixel obs in image 1
    idx0: torch.Tensor  # (M,) feature slot in image 0
    idx1: torch.Tensor  # (M,) feature slot in image 1
    valid: torch.Tensor  # (M,) surviving correspondences
    num_matches: torch.Tensor  # () ratio-test survivors
    num_inliers: torch.Tensor  # () E-RANSAC inliers
    reproj_error: torch.Tensor  # () mean reprojection error (reference metric)


def bootstrap(gen: Optional[torch.Generator], feats0: Features, feats1: Features,
              K: torch.Tensor, cfg: SfmConfig) -> TwoViewResult:
    """Initialize from the first image pair: pose0 = [I|0], pose1 = [R_rel|t_rel]."""
    fc, rc = cfg.frontend, cfg.ransac
    m = matching.match_with_config(feats0.desc, feats1.desc, feats0.valid, feats1.valid, fc)
    uv0, uv1, mvalid = matching.gather_match_points(feats0.xy, feats1.xy, m)
    n0 = projection.normalize_points(uv0, K)
    n1 = projection.normalize_points(uv1, K)
    focal = 0.5 * (K[0, 0] + K[1, 1])

    res = ransac.ransac_essential(
        gen, n0, n1, mvalid, focal,
        threshold_px=rc.essential_threshold_px, iters=rc.essential_iters,
        refit_rounds=rc.refit_rounds, solver=rc.essential_solver,
    )
    R_e, t_e, cheir_e = epipolar.recover_pose(res.model, n0, n1, res.inliers)

    # Model selection: for (near-)planar scenes E is ambiguous; when a
    # homography explains clearly more matches, take its pose.
    h_res = ransac.ransac_homography(
        gen, n0, n1, mvalid,
        threshold_px=rc.essential_threshold_px / focal,
        iters=rc.homography_iters,
    )
    R_h, t_h, cheir_h = epipolar.recover_pose_from_homography(
        h_res.model, n0, n1, h_res.inliers)
    s_e = res.num_inliers.to(torch.float32)
    s_h = h_res.num_inliers.to(torch.float32)
    use_h = s_h > 0.42 * (s_h + s_e)
    R_rel = torch.where(use_h, R_h, R_e)
    t_rel = torch.where(use_h, t_h, t_e)
    cheir = torch.where(use_h, cheir_h, cheir_e)
    inl = torch.where(use_h, h_res.inliers, res.inliers)
    R_rel, t_rel = epipolar.refine_relative_pose(R_rel, t_rel, n0, n1, inl & cheir)

    pose0 = torch.cat([torch.eye(3, dtype=K.dtype, device=K.device),
                       torch.zeros((3, 1), dtype=K.dtype, device=K.device)], dim=1)
    pose1 = torch.cat([R_rel, t_rel[:, None]], dim=1)

    X = triangulation.triangulate_euclidean(K @ pose0, K @ pose1, uv0, uv1)
    d0, d1 = triangulation.triangulation_depths(pose0, pose1, X)
    err1 = torch.linalg.norm(projection.reprojection_residuals(X, uv1, pose1, K), dim=-1)
    err0 = torch.linalg.norm(projection.reprojection_residuals(X, uv0, pose0, K), dim=-1)
    good = (cheir & (d0 > 0) & (d1 > 0)
            & (err0 < rc.pnp_threshold_px) & (err1 < rc.pnp_threshold_px))
    mean_err = projection.masked_mean_reprojection_error(X, uv1, pose1, K, good)
    return TwoViewResult(
        pose0=pose0, pose1=pose1, points=X, uv0=uv0, uv1=uv1,
        idx0=m.idx0, idx1=m.idx1, valid=good,
        num_matches=mvalid.sum(), num_inliers=res.num_inliers,
        reproj_error=mean_err,
    )
