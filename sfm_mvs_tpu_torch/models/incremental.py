"""Incremental SfM driver: bootstrap, then register-PnP-triangulate per frame.

PyTorch port of ``sfm_mvs_tpu/models/incremental.py`` on its sequential
path. The per-frame step (:func:`register_frame`) is branch-free tensor
code over fixed-capacity masked state, like the JAX package's one jitted
function: integer track ids per feature slot of the newest frame carry the
data association, PnP-RANSAC registers the frame, batched DLT triangulates
new points, and masked appends grow the map.

Duplicate scatter targets: the track-id vector for a frame's feature slots
is written at ``slot = matches.idx1``, which can repeat (the matcher is
one-directional). XLA on CPU applies such writes in order, so the highest
match slot wins; the port implements that rule deterministically (a
scatter-max of the match slot, then a gather) instead of a raw indexed
write, whose winner on CUDA is unspecified.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from sfm_mvs_tpu_torch.models import map_store
from sfm_mvs_tpu_torch.models.map_store import MapState
from sfm_mvs_tpu_torch.models.two_view import bootstrap
from sfm_mvs_tpu_torch.ops import matching, projection, ransac, sift, triangulation
from sfm_mvs_tpu_torch.ops.sift import Features
from sfm_mvs_tpu_torch.utils.config import SfmConfig


class FrameStats(NamedTuple):
    num_matches: torch.Tensor  # () matches to previous frame
    num_tracked: torch.Tensor  # () matches with existing 3D points
    num_pnp_inliers: torch.Tensor  # () PnP inliers
    num_new_points: torch.Tensor  # () newly triangulated points
    reproj_error: torch.Tensor  # () reference-metric mean reprojection error
    accepted: torch.Tensor  # () bool — False when the frame was rejected


class PipelineState(NamedTuple):
    """Carried across frames (the reference's sliding window)."""

    map: MapState
    prev_feats: Features
    prev_track: torch.Tensor  # (max_features,) int32 point id per feature slot


def _sample_colors(image_bgr: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel BGR color at uv, integer truncation like the reference."""
    H, W = image_bgr.shape[0], image_bgr.shape[1]
    x = torch.clamp(uv[:, 0].to(torch.int64), 0, W - 1)
    y = torch.clamp(uv[:, 1].to(torch.int64), 0, H - 1)
    return image_bgr[y, x].to(torch.float32)


def _undistort_features(feats: Features, K: torch.Tensor, cfg: SfmConfig) -> Features:
    """Front-door radial-distortion correction (cfg.k1/k2; zero = no-op)."""
    if cfg.k1 == 0.0 and cfg.k2 == 0.0:
        return feats
    dist = torch.tensor([cfg.k1, cfg.k2], dtype=feats.xy.dtype, device=feats.xy.device)
    return feats._replace(xy=projection.undistort_pixels(feats.xy, K, dist))


def _track_vector(max_feat: int, slot: torch.Tensor, write: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """(max_feat,) int32 track ids: track[slot[i]] = values[i] where write[i].

    Where several rows write one slot, the highest row index wins (the
    order XLA's CPU scatter applies them in).
    """
    dest = torch.where(write, slot.long(), torch.full_like(slot, max_feat).long())
    rows = torch.arange(dest.shape[0], device=dest.device)
    winner = torch.full((max_feat + 1,), -1, dtype=torch.int64, device=dest.device)
    winner = winner.scatter_reduce(0, dest, rows, reduce="amax")[:max_feat]
    picked = values.to(torch.int32)[torch.clamp_min(winner, 0)]
    return torch.where(winner >= 0, picked, torch.full_like(picked, -1))


def init_from_bootstrap(gen, feats0: Features, feats1: Features, image1_bgr, K,
                        cfg: SfmConfig):
    """Run the two-view bootstrap and materialize the initial map.

    Returns (PipelineState, FrameStats).
    """
    tv = bootstrap(gen, feats0, feats1, K, cfg)
    state = map_store.init_map(K, cfg.map, device=K.device)
    state, cam0 = map_store.append_camera(state, tv.pose0)
    state, cam1 = map_store.append_camera(state, tv.pose1)
    colors = _sample_colors(image1_bgr, tv.uv1)
    state, pids = map_store.append_points(state, tv.points, colors, tv.valid)
    state = map_store.append_observations(state, cam0, pids, tv.uv0, tv.valid)
    state = map_store.append_observations(state, cam1, pids, tv.uv1, tv.valid)
    track = _track_vector(feats1.xy.shape[0], tv.idx1, tv.valid, pids)
    n_valid = tv.valid.sum()
    stats = FrameStats(
        num_matches=tv.num_matches, num_tracked=n_valid,
        num_pnp_inliers=tv.num_inliers, num_new_points=n_valid,
        reproj_error=tv.reproj_error,
        accepted=torch.ones((), dtype=torch.bool, device=K.device),
    )
    return PipelineState(map=state, prev_feats=feats1, prev_track=track), stats


def _select(accepted: torch.Tensor, new, old):
    """Field-wise torch.where over two equal-structured NamedTuples."""
    out = []
    for a, b in zip(new, old):
        if isinstance(a, tuple):
            out.append(_select(accepted, a, b))
        else:
            out.append(torch.where(accepted, a, b))
    return type(new)(*out)


def register_frame(gen, pstate: PipelineState, new_feats: Features, image_bgr,
                   cfg: SfmConfig):
    """Register one new frame against the map, matched to the previous frame
    (the most recently appended camera).

    Returns (PipelineState, FrameStats); a frame with too few PnP inliers
    is rejected and the input state returned unchanged.
    """
    fc, rc = cfg.frontend, cfg.ransac
    state = pstate.map
    K = state.K
    prev = pstate.prev_feats
    P = state.points.shape[0]

    # 1. Match previous frame -> new frame.
    m = matching.match_with_config(prev.desc, new_feats.desc, prev.valid, new_feats.valid, fc)
    uv_prev, uv_new, mvalid = matching.gather_match_points(prev.xy, new_feats.xy, m)

    # 2. Split into tracked (have 3D) / untracked.
    tids = pstate.prev_track[m.idx0.long()]
    safe_tids = torch.clamp(tids, 0, P - 1).long()
    tracked = mvalid & (tids >= 0) & state.point_valid[safe_tids]
    X_tracked = state.points[safe_tids]

    # 3. PnP-RANSAC on the 2D-3D correspondences.
    uv_new_norm = projection.normalize_points(uv_new, K)
    pnp_res = ransac.ransac_pnp(
        gen, X_tracked, uv_new, uv_new_norm, tracked, K,
        threshold_px=rc.pnp_threshold_px, iters=rc.pnp_iters, use_p3p=rc.pnp_use_p3p)
    pose_new = pnp_res.model
    state, cam_new = map_store.append_camera(state, pose_new)
    prev_cam = cam_new - 1
    pose_prev = state.poses[prev_cam.long()]

    # 4. Observations of existing points in the new frame (PnP inliers).
    state = map_store.append_observations(state, cam_new, tids, uv_new, pnp_res.inliers)
    err_tracked = projection.masked_mean_reprojection_error(
        X_tracked, uv_new, pose_new, K, pnp_res.inliers)

    # 5. Triangulate brand-new points from untracked matches.
    untracked = mvalid & (tids < 0)
    X_new = triangulation.triangulate_euclidean(K @ pose_prev, K @ pose_new, uv_prev, uv_new)
    d0, d1 = triangulation.triangulation_depths(pose_prev, pose_new, X_new)
    e_prev = torch.linalg.norm(
        projection.reprojection_residuals(X_new, uv_prev, pose_prev, K), dim=-1)
    e_new = torch.linalg.norm(
        projection.reprojection_residuals(X_new, uv_new, pose_new, K), dim=-1)
    good_new = (untracked & (d0 > 0) & (d1 > 0)
                & (e_prev < rc.pnp_threshold_px) & (e_new < rc.pnp_threshold_px))

    # 5b. Re-observation merging: a "new" candidate that projects onto a
    # recent map point in this camera with consistent depth extends that
    # point's track instead of duplicating it.
    merge_tid = torch.full(good_new.shape, -1, dtype=torch.int32, device=K.device)
    if rc.merge_reobservations:
        Wm = min(rc.merge_window, P)
        start = torch.clamp(state.num_points - Wm, 0, P - Wm)
        win = start + torch.arange(Wm, dtype=torch.int32, device=K.device)
        win_pts = state.points[win.long()]
        win_valid = state.point_valid[win.long()]
        win_uv, win_depth = projection.project_depth(win_pts, pose_new, K)
        win_ok = win_valid & (win_depth > 0)
        d2_px = ((uv_new * uv_new).sum(1, keepdim=True)
                 + (win_uv * win_uv).sum(1)[None, :]
                 - 2.0 * uv_new @ win_uv.T)
        d2_px = torch.where(win_ok[None, :], d2_px, torch.full_like(d2_px, float("inf")))
        nearest = torch.argmin(d2_px, dim=1)
        dmin = d2_px.min(dim=1).values
        near_depth = win_depth[nearest]
        depth_ok = (near_depth - d1).abs() < rc.merge_depth_rel * torch.clamp_min(near_depth, 1e-6)
        merged = good_new & (dmin < rc.merge_px ** 2) & depth_ok
        merge_tid = torch.where(merged, win[nearest], merge_tid)
        good_new = good_new & ~merged
        state = map_store.append_observations(state, cam_new, merge_tid, uv_new, merged)
    colors = _sample_colors(image_bgr, uv_new)
    state, new_pids = map_store.append_points(state, X_new, colors, good_new)
    state = map_store.append_observations(state, prev_cam, new_pids, uv_prev, good_new)
    state = map_store.append_observations(state, cam_new, new_pids, uv_new, good_new)
    err_new = projection.masked_mean_reprojection_error(X_new, uv_new, pose_new, K, good_new)

    # 6. Track ids for the new frame's feature slots.
    neg = torch.full_like(tids, -1)
    keep_tid = torch.where(pnp_res.inliers, tids, neg)
    keep_tid = torch.where(good_new, new_pids, keep_tid)
    keep_tid = torch.where(merge_tid >= 0, merge_tid, keep_tid)
    track = _track_vector(new_feats.xy.shape[0], m.idx1,
                          pnp_res.inliers | good_new | (merge_tid >= 0), keep_tid)
    new_pstate = PipelineState(map=state, prev_feats=new_feats, prev_track=track)

    # Degenerate-frame guard: too few PnP inliers -> reject the whole update.
    accepted = pnp_res.num_inliers >= rc.min_pnp_inliers
    stats = FrameStats(
        num_matches=mvalid.sum(),
        num_tracked=tracked.sum(),
        num_pnp_inliers=pnp_res.num_inliers,
        num_new_points=torch.where(accepted, good_new.sum(), torch.zeros_like(good_new.sum())),
        reproj_error=0.5 * (err_tracked + err_new),
        accepted=accepted,
    )
    return _select(accepted, new_pstate, pstate), stats


class IncrementalSfM:
    """Host-side driver: detect -> bootstrap/register, frame by frame.

    Every tensor lives on `device`. Ported so far: the sequential path of
    the JAX package's ``IncrementalSfM.run`` with bundle adjustment off (the
    CLI default, ``BaConfig.enabled=False``).
    """

    def __init__(self, config: Optional[SfmConfig] = None, device="cpu",
                 checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0):
        self.config = config or SfmConfig()
        self.device = torch.device(device)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.stats: list[dict] = []

    def finalize(self, *args, **kwargs) -> MapState:
        raise NotImplementedError(
            "finalize (cull + global BA + densify sweep) is not ported yet "
            "(ROADMAP A7, A9)")

    def _check_supported(self) -> None:
        cfg = self.config
        if cfg.ba.enabled:
            raise NotImplementedError(
                "bundle adjustment (cfg.ba.enabled) is not ported yet (ROADMAP A7)")
        if cfg.bootstrap != "seq":
            raise NotImplementedError(
                f"bootstrap={cfg.bootstrap!r}: only the sequential bootstrap is "
                "ported; the view-graph driver waits (ROADMAP A10)")
        if self.checkpoint_dir and self.checkpoint_every:
            raise NotImplementedError("checkpoints are not ported yet (ROADMAP A10)")

    def run(self, images_gray: Sequence[np.ndarray],
            images_bgr: Optional[Sequence[np.ndarray]] = None,
            seed: int = 0) -> MapState:
        """Reconstruct from an ordered image sequence.

        images_gray: list of (H, W) float32 in [0, 1]. images_bgr: optional
        matching (H, W, 3) color images for point colors; grayscale is
        replicated when absent. Per-frame stats go to ``self.stats``.
        """
        self._check_supported()
        cfg = self.config
        dev = self.device
        K = torch.as_tensor(cfg.intrinsic_matrix(), device=dev)
        if images_bgr is None:
            images_bgr = [np.repeat((g * 255.0)[..., None], 3, axis=-1) for g in images_gray]

        def get_feats(i):
            img = torch.as_tensor(np.asarray(images_gray[i], np.float32), device=dev)
            return _undistort_features(sift.detect_and_compute(img, cfg.frontend), K, cfg)

        def bgr(i):
            return torch.as_tensor(np.asarray(images_bgr[i], np.float32), device=dev)

        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        t0 = time.perf_counter()
        f0, f1 = get_feats(0), get_feats(1)
        pstate, st = init_from_bootstrap(gen, f0, f1, bgr(1), K, cfg)
        self._record(1, st, self._wait(t0))
        for i in range(2, len(images_gray)):
            t0 = time.perf_counter()
            pstate, st = register_frame(gen, pstate, get_feats(i), bgr(i), cfg)
            self._record(i, st, self._wait(t0))
        self.state = pstate
        return pstate.map

    def _wait(self, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _record(self, frame: int, st: FrameStats, wall_s: float) -> None:
        self.stats.append({
            "frame": frame,
            "matches": int(st.num_matches),
            "tracked": int(st.num_tracked),
            "pnp_inliers": int(st.num_pnp_inliers),
            "new_points": int(st.num_new_points),
            "reproj_error": float(st.reproj_error),
            "accepted": bool(st.accepted),
            "wall_s": wall_s,
        })
