"""Final densification sweep: per-pair re-match + triangulate-everything.

PyTorch port of ``sfm_mvs_tpu/models/densify.py``. The registration loop
keeps a deduplicated track map so per-frame BA stays small; this one-time
finalize step restores the reference's cloud density after the trajectory
is solved:

- the map's point capacity is grown once (``map_store.grow_map``);
- every frame pair (i, i + s) for each stride s is re-matched (through
  ``matching.match_with_config``, so CUDA tensors go through the 2-NN
  kernel) and every good match is triangulated from the final poses;
- a candidate that coincides with an existing map point (projected pixel
  distance and relative depth in the second camera) is dropped as a
  duplicate; the test against the whole map runs in chunks of (M, 8192)
  distance matrices.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from sfm_mvs_tpu_torch.models import ba as ba_mod
from sfm_mvs_tpu_torch.models import map_store, refine
from sfm_mvs_tpu_torch.models.map_store import MapState
from sfm_mvs_tpu_torch.ops import matching, projection, sift, triangulation
from sfm_mvs_tpu_torch.ops.sift import Features
from sfm_mvs_tpu_torch.utils.config import FrontendConfig, SfmConfig


def sweep_frontend_config(cfg: SfmConfig) -> FrontendConfig:
    """The detection/matching config the sweep runs with: the run's
    frontend, with budget/threshold/ratio overridden where SweepConfig sets
    them (> 0)."""
    sw = cfg.sweep
    repl = {}
    if sw.max_features > 0:
        repl["max_features"] = sw.max_features
    if sw.contrast_threshold > 0:
        repl["contrast_threshold"] = sw.contrast_threshold
    if sw.lowe_ratio > 0:
        repl["lowe_ratio"] = sw.lowe_ratio
    return dataclasses.replace(cfg.frontend, **repl) if repl else cfg.frontend


def _nearest_map_point(uv_cand, uv_map, depth_map, valid_map):
    """Per-candidate nearest projected map point: (min_d2 (M,), depth (M,)).

    A running minimum over chunks of 8192 map points, so the full (M, P)
    distance matrix never materializes. Within a chunk argmin keeps the
    first index; across chunks the update is strict, so the lowest index
    wins ties, as in the JAX package (whose last chunk overlaps the one
    before it; re-scoring a row cannot change a strict running minimum).
    The cross term is a broadcast product: as a GEMM with inner dimension
    2, cuBLAS takes a slow small-matrix path on the card.
    """
    M, P = uv_cand.shape[0], uv_map.shape[0]
    chunk = 8192
    sq_c = (uv_cand * uv_cand).sum(1)
    u, v = uv_cand[:, 0, None], uv_cand[:, 1, None]
    dmin = torch.full((M,), float("inf"), dtype=torch.float32, device=uv_cand.device)
    zmin = torch.zeros((M,), dtype=torch.float32, device=uv_cand.device)
    for s in range(0, P, chunk):
        uvb = uv_map[s:s + chunk]
        cross = u * uvb[:, 0] + v * uvb[:, 1]
        d2 = sq_c[:, None] + (uvb * uvb).sum(1)[None, :] - 2.0 * cross
        d2 = torch.where(valid_map[None, s:s + chunk], d2, torch.full_like(d2, float("inf")))
        dblk, j = d2.min(dim=1)
        better = dblk < dmin
        dmin = torch.where(better, dblk, dmin)
        zmin = torch.where(better, depth_map[s:s + chunk][j], zmin)
    return dmin, zmin


def sweep_pair(state: MapState, cam0, cam1, feats0: Features, feats1: Features,
               image_bgr1: torch.Tensor, cfg: SfmConfig):
    """Triangulate every good match of one frame pair into the map.

    cam0, cam1: camera ids (ints or 0-dim tensors). Returns (state,
    num_added), num_added a 0-dim tensor.
    """
    sw = cfg.sweep
    K = state.K
    pose0 = state.poses[cam0]
    pose1 = state.poses[cam1]

    m = matching.match_with_config(feats0.desc, feats1.desc, feats0.valid, feats1.valid,
                                   cfg.frontend)
    uv0, uv1, mvalid = matching.gather_match_points(feats0.xy, feats1.xy, m)

    X = triangulation.triangulate_euclidean(K @ pose0, K @ pose1, uv0, uv1)
    d0, d1 = triangulation.triangulation_depths(pose0, pose1, X)
    e0 = torch.linalg.norm(projection.reprojection_residuals(X, uv0, pose0, K), dim=-1)
    e1 = torch.linalg.norm(projection.reprojection_residuals(X, uv1, pose1, K), dim=-1)
    good = mvalid & (d0 > 0) & (d1 > 0) & (e0 < sw.reproj_px) & (e1 < sw.reproj_px)

    # Dedup against the live map: a candidate whose projection in cam1
    # lands within dedup_px of an existing point at consistent depth is a
    # re-observation, not a new point.
    uv_map, depth_map = projection.project_depth(state.points, pose1, K)
    dmin2, z_near = _nearest_map_point(uv1, uv_map, depth_map,
                                       state.point_valid & (depth_map > 0))
    dup = (dmin2 < sw.dedup_px ** 2) & (
        (z_near - d1).abs() < sw.dedup_depth_rel * torch.clamp_min(z_near, 1e-6))
    good = good & ~dup

    H, W = image_bgr1.shape[0], image_bgr1.shape[1]
    xi = torch.clamp(uv1[:, 0].to(torch.int64), 0, W - 1)
    yi = torch.clamp(uv1[:, 1].to(torch.int64), 0, H - 1)
    colors = image_bgr1[yi, xi].to(torch.float32)

    state, pids = map_store.append_points(state, X, colors, good)
    state = map_store.append_observations(state, cam0, pids, uv0, good)
    state = map_store.append_observations(state, cam1, pids, uv1, good)
    return state, good.sum()


def densify_sweep(state: MapState, feats: Sequence[Features],
                  images_bgr: Optional[Sequence] = None,
                  cfg: Optional[SfmConfig] = None):
    """Run the sweep over the pairs of every stride (host loop).

    feats[i] must belong to camera i of the map. images_bgr (numpy arrays
    or tensors) supplies point colors; mid-gray when absent. Returns
    (state, points added).
    """
    cfg = cfg or SfmConfig()
    cfg = dataclasses.replace(cfg, frontend=sweep_frontend_config(cfg))
    dev = state.points.device
    n = int(state.num_cams)
    points_before = int(state.num_points)
    gray = torch.full((2, 2, 3), 128.0, dtype=torch.float32, device=dev)
    for stride in cfg.sweep.pair_strides:
        stride = max(1, int(stride))
        for i in range(0, n - stride):
            img = (gray if images_bgr is None else
                   torch.as_tensor(images_bgr[i + stride], dtype=torch.float32, device=dev))
            state, _ = sweep_pair(state, i, i + stride, feats[i], feats[i + stride], img, cfg)
    # Count what landed: append_points drops candidates once the capacity
    # is exhausted, so the per-pair counts over-report.
    points_after = int(state.num_points)
    if points_after >= state.points.shape[0]:
        warnings.warn(
            f"densify sweep filled the map's point capacity ({state.points.shape[0]}); "
            "further candidates were dropped; raise sweep.grow_points to keep them")
    return state, points_after - points_before


def redetect_for_sweep(images_gray: Sequence, cfg: SfmConfig,
                       K: Optional[torch.Tensor] = None, device="cuda") -> list[Features]:
    """Detect sweep features at the sweep's (denser) budget for each frame.

    Frames that are tensors are detected where they lie; numpy frames on
    K's device when K is given, else on `device` (default ``cuda``, which
    raises without CUDA; pass ``device="cpu"`` there). With nonzero
    cfg.k1/k2 (and K given) the keypoints are undistorted once here, as the
    driver does at detection.
    """
    from sfm_mvs_tpu_torch.models.incremental import _undistort_features, resolve_device

    fc = sweep_frontend_config(cfg)
    dev = None
    feats = []
    for g in images_gray:
        if not isinstance(g, torch.Tensor):
            if dev is None:
                dev = K.device if K is not None else resolve_device(device)
            g = torch.as_tensor(np.asarray(g, np.float32), device=dev)
        feats.append(sift.detect_and_compute(g.to(torch.float32), fc))
    if K is not None and (cfg.k1 != 0.0 or cfg.k2 != 0.0):
        feats = [_undistort_features(f, K, cfg) for f in feats]
    return feats


def finalize_with_sweep(state: MapState, feats: Sequence[Features],
                        images_bgr: Optional[Sequence] = None,
                        cfg: Optional[SfmConfig] = None, cull_px: float = 4.0,
                        images_gray: Optional[Sequence] = None):
    """Grow -> sweep -> cull -> final global BA. Returns (state, info).

    When SweepConfig overrides the detection budget and `images_gray` is
    given, features are re-detected at the sweep budget instead of reusing
    `feats`.
    """
    cfg = cfg or SfmConfig()
    info: dict = {}
    if images_gray is not None and sweep_frontend_config(cfg) is not cfg.frontend:
        feats = redetect_for_sweep(images_gray, cfg, K=state.K)
    state = map_store.grow_map(state, cfg.sweep.grow_points)
    state, info["swept_points"] = densify_sweep(state, feats, images_bgr, cfg)
    if cfg.sweep.final_ba_iters > 0:
        state = refine.cull_map(state, max_error_px=cull_px)
        state, ba_stats = ba_mod.bundle_adjust_map(state, max_iterations=cfg.sweep.final_ba_iters)
        info["final_cost"] = float(ba_stats.final_cost)
    info["points"] = int(state.point_valid.sum())
    return state, info
