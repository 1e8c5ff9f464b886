"""Track-based global SfM: the reference's test.py pipeline.

PyTorch port of ``sfm_mvs_tpu/models/tracks.py``: per-adjacent-pair
matching with E and homography estimation (test.py:219-281),
homography-chained feature tracks (feat_to_tracks, test.py:10-26),
triangulation of the (0, 1) pair from the track columns (test.py:296-311),
PnP of every later camera against that one cloud (test.py:315-326), a
global reprojection audit and global bundle adjustment (test.py:330-335),
and a final per-adjacent-pair triangulation sweep (test.py:339-380).

As in the JAX package, homographies come from the batched 4-point DLT
RANSAC and the global BA keeps the observations fixed. Every pair's
matches go through the 2-NN kernel on CUDA tensors (its wrapper takes the
plain version for CPU tensors), or the plain matcher with
``use_pallas_matcher=False``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from sfm_mvs_tpu_torch.models import ba as ba_mod
from sfm_mvs_tpu_torch.models import map_store
from sfm_mvs_tpu_torch.models.exhaustive import _match
from sfm_mvs_tpu_torch.models.incremental import resolve_device
from sfm_mvs_tpu_torch.models.map_store import MapState
from sfm_mvs_tpu_torch.ops import homography, matching, projection, ransac, sift, triangulation
from sfm_mvs_tpu_torch.ops.epipolar import recover_pose
from sfm_mvs_tpu_torch.ops.sift import Features
from sfm_mvs_tpu_torch.utils.config import SfmConfig


class PairEstimate(NamedTuple):
    """Adjacent-pair geometry (the reference's per-pair loop state)."""

    H: torch.Tensor  # (3, 3) homography frame i -> i+1
    R: torch.Tensor  # (3, 3) relative rotation
    t: torch.Tensor  # (3,) relative translation (unit norm)
    num_inliers: torch.Tensor  # () E-RANSAC inliers


def estimate_pair(gen, feats0: Features, feats1: Features, K, cfg: SfmConfig) -> PairEstimate:
    """Match one adjacent pair; estimate E (-> relative pose) and H."""
    fc, rc = cfg.frontend, cfg.ransac
    m = matching.match_with_config(feats0.desc, feats1.desc, feats0.valid, feats1.valid, fc)
    uv0, uv1, mvalid = matching.gather_match_points(feats0.xy, feats1.xy, m)
    n0 = projection.normalize_points(uv0, K)
    n1 = projection.normalize_points(uv1, K)
    e_res = ransac.ransac_essential(gen, n0, n1, mvalid, 0.5 * (K[0, 0] + K[1, 1]),
                                    threshold_px=rc.essential_threshold_px,
                                    iters=rc.essential_iters)
    R, t, _ = recover_pose(e_res.model, n0, n1, e_res.inliers)
    h_res = ransac.ransac_homography(gen, uv0, uv1, mvalid,
                                     threshold_px=rc.homography_threshold_px,
                                     iters=rc.homography_iters)
    return PairEstimate(H=h_res.model, R=R, t=t, num_inliers=e_res.num_inliers)


def chain_tracks(kp_last: torch.Tensor, valid_last: torch.Tensor, homographies: torch.Tensor,
                 image_size):
    """Warp the last frame's keypoints back through chained homographies.

    The reference's feat_to_tracks (test.py:10-26): with F-1 adjacent
    homographies H_i (frame i -> i+1), the last frame's keypoints are
    mapped into every earlier frame by the composed inverses, walking
    backward. kp_last: (N, 2); homographies: (F-1, 3, 3); image_size:
    (W, H). Returns (tracks (F, N, 2), track_valid (F, N)).
    """
    W, H = float(image_size[0]), float(image_size[1])
    pts = kp_last
    warped = []
    for Hmat in reversed(list(homographies)):
        pts = homography.apply_homography(torch.linalg.inv_ex(Hmat)[0], pts)
        warped.append(pts)
    tracks = torch.stack(warped[::-1] + [kp_last])  # (F, N, 2)
    inside = ((tracks[..., 0] >= 0) & (tracks[..., 0] <= W - 1)
              & (tracks[..., 1] >= 0) & (tracks[..., 1] <= H - 1))
    return tracks, inside & valid_last[None, :]


def _gray_colors(gray: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel (truncated) gray value * 255 as a BGR triple."""
    Hh, Ww = gray.shape
    xi = torch.clamp(uv[:, 0].to(torch.int64), 0, Ww - 1)
    yi = torch.clamp(uv[:, 1].to(torch.int64), 0, Hh - 1)
    g = gray[yi, xi] * 255.0
    return torch.stack([g, g, g], dim=-1)


class GlobalSfM:
    """Host driver for the track-based global pipeline (test.py analog).

    Every tensor lives on `device` (default ``cuda``; without a GPU pass
    ``device="cpu"``).
    """

    def __init__(self, config: Optional[SfmConfig] = None, device="cuda"):
        self.config = config or SfmConfig()
        self.device = resolve_device(device)
        self.stats: list[dict] = []

    def _detect(self, images_gray) -> list[Features]:
        return [sift.detect_and_compute(self._gray(g), self.config.frontend)
                for g in images_gray]

    def _gray(self, g) -> torch.Tensor:
        return torch.as_tensor(np.asarray(g, np.float32), device=self.device)

    def run(self, images_gray: Sequence[np.ndarray], seed: int = 0,
            run_ba: bool = True) -> MapState:
        """Reconstruct every frame of the sequence; returns the map (also
        ``self.state``, with the tracks in ``self.tracks``/``track_valid``).
        The RANSAC draws come from one generator seeded with `seed`."""
        cfg = self.config
        dev = self.device
        K = torch.as_tensor(cfg.intrinsic_matrix(), device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        feats = self._detect(images_gray)
        F = len(feats)

        # 1. Adjacent-pair geometry (test.py:219-281).
        pairs = [estimate_pair(gen, feats[i], feats[i + 1], K, cfg) for i in range(F - 1)]
        Hs = torch.stack([p.H for p in pairs])

        # 2. Homography-chained tracks from the last frame's keypoints.
        H_img, W_img = np.asarray(images_gray[0]).shape
        tracks, tvalid = chain_tracks(feats[-1].xy, feats[-1].valid, Hs, (W_img, H_img))

        # 3. Poses of frames 0 and 1 from the pair's relative pose, and the
        #    track columns triangulated (test.py:296-311).
        pose0 = torch.eye(3, 4, dtype=torch.float32, device=dev)
        pose1 = torch.cat([pairs[0].R, pairs[0].t[:, None]], dim=1)
        X = triangulation.triangulate_euclidean(K @ pose0, K @ pose1, tracks[0], tracks[1])
        d0, d1 = triangulation.triangulation_depths(pose0, pose1, X)
        pvalid = tvalid[0] & tvalid[1] & (d0 > 0) & (d1 > 0)
        err1 = projection.masked_mean_reprojection_error(X, tracks[1], pose1, K, pvalid)
        self.stats.append({"frame": 1, "pnp_inliers": int(pvalid.sum()),
                           "reproj_error": float(err1)})

        # 4. Every later camera by PnP against this one cloud (test.py:315-326).
        poses = [pose0, pose1]
        for i in range(2, F):
            uv_i = tracks[i]
            res = ransac.ransac_pnp(gen, X, uv_i, projection.normalize_points(uv_i, K),
                                    pvalid & tvalid[i], K,
                                    threshold_px=cfg.ransac.pnp_threshold_px,
                                    iters=cfg.ransac.pnp_iters,
                                    use_p3p=cfg.ransac.pnp_use_p3p)
            poses.append(res.model)
            err_i = projection.masked_mean_reprojection_error(X, uv_i, res.model, K, res.inliers)
            self.stats.append({"frame": i, "pnp_inliers": int(res.num_inliers),
                               "reproj_error": float(err_i)})

        # 5. The map: cameras, points, per-frame observations.
        state = map_store.init_map(K, cfg.map)
        for pose in poses:
            state, _ = map_store.append_camera(state, pose)
        colors = _gray_colors(self._gray(images_gray[0]), tracks[0])
        state, pids = map_store.append_points(state, X, colors, pvalid)
        for i in range(F):
            state = map_store.append_observations(state, i, pids, tracks[i], pvalid & tvalid[i])

        # 6. Global audit + global BA (test.py:330-335), observations fixed.
        cost_before = float(ba_mod._cost(ba_mod.problem_from_map(state)))
        if run_ba:
            state, ba_stats = ba_mod.bundle_adjust_map(state, max_iterations=cfg.ba.max_iterations)
            self.stats.append({"event": "global_ba", "cost_before": cost_before,
                               "cost_after": float(ba_stats.final_cost)})
        self.state = state
        self.tracks = tracks
        self.track_valid = tvalid
        return state

    def final_sweep(self, images_gray: Sequence[np.ndarray], seed: int = 1) -> MapState:
        """Per-adjacent-pair match + triangulation sweep (test.py:339-380):
        densifies the cloud from the bundle-adjusted poses. Features are
        detected anew; `seed` is unused (no RANSAC), as in the JAX package."""
        cfg = self.config
        state = self.state
        K = torch.as_tensor(cfg.intrinsic_matrix(), device=state.points.device)
        feats = self._detect(images_gray)
        thr = cfg.ransac.pnp_threshold_px
        for i in range(len(feats) - 1):
            m = _match(feats[i], feats[i + 1], cfg)
            uv0, uv1, mvalid = matching.gather_match_points(feats[i].xy, feats[i + 1].xy, m)
            p0, p1 = state.poses[i], state.poses[i + 1]
            X = triangulation.triangulate_euclidean(K @ p0, K @ p1, uv0, uv1)
            d0, d1 = triangulation.triangulation_depths(p0, p1, X)
            e0 = torch.linalg.norm(projection.reprojection_residuals(X, uv0, p0, K), dim=-1)
            e1 = torch.linalg.norm(projection.reprojection_residuals(X, uv1, p1, K), dim=-1)
            good = mvalid & (d0 > 0) & (d1 > 0) & (e0 < thr) & (e1 < thr)
            colors = _gray_colors(self._gray(images_gray[i]), uv0)
            state, pids = map_store.append_points(state, X, colors, good)
            state = map_store.append_observations(state, i, pids, uv0, good)
            state = map_store.append_observations(state, i + 1, pids, uv1, good)
        self.state = state
        return state
