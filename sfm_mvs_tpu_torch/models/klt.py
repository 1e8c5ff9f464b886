"""KLT-tracking incremental SfM: the front end the reference abandoned.

PyTorch port of ``sfm_mvs_tpu/models/klt.py``. The reference's
commented-out experiment (sfm.py:249-257) replaces descriptor re-matching
with Lucas-Kanade tracking between consecutive frames:

- per frame, the feature positions are tracked into the new image
  (ops/optical_flow.py): no detection or matching on most frames;
- tracked features with 3D points drive PnP registration; tracked
  features without one are triangulated against the previous camera;
- lost tracks are replenished by re-detection every `redetect_every`
  frames, away from surviving tracks.

Slot semantics: slot i of the track table carries one feature across
frames until it dies; replenishment re-uses dead slots. The only match is
the bootstrap's, which goes through the 2-NN kernel on CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from sfm_mvs_tpu_torch.models import map_store
from sfm_mvs_tpu_torch.models.incremental import _select, _track_vector, frame_generator
from sfm_mvs_tpu_torch.models.map_store import MapState
from sfm_mvs_tpu_torch.models.tracks import _gray_colors
from sfm_mvs_tpu_torch.models.two_view import bootstrap
from sfm_mvs_tpu_torch.ops import optical_flow, projection, ransac, sift, triangulation
from sfm_mvs_tpu_torch.ops.sift import Features
from sfm_mvs_tpu_torch.utils.config import SfmConfig
from sfm_mvs_tpu_torch.utils.device import resolve_device


class KltState(NamedTuple):
    map: MapState
    prev_gray: torch.Tensor  # (H, W) previous frame
    positions: torch.Tensor  # (S, 2) current feature positions
    track_ids: torch.Tensor  # (S,) int32 3D point id per slot (-1 = not yet)
    alive: torch.Tensor  # (S,) slot carries a live feature


class KltStats(NamedTuple):
    num_tracked: torch.Tensor
    num_pnp_inliers: torch.Tensor
    num_new_points: torch.Tensor
    reproj_error: torch.Tensor


def klt_step(gen, state: KltState, new_gray: torch.Tensor, cfg: SfmConfig,
             sample_idx: Optional[torch.Tensor] = None,
             sample_idx3: Optional[torch.Tensor] = None) -> tuple[KltState, KltStats]:
    """Track -> register -> triangulate one frame. sample_idx / sample_idx3:
    optional injected PnP samples (``ransac.ransac_pnp``). A frame with too
    few PnP inliers leaves the state as it was, but for ``prev_gray``."""
    rc = cfg.ransac
    m = state.map
    K = m.K
    thr = rc.pnp_threshold_px

    # 1. Track every live slot into the new frame.
    flow = optical_flow.track_points(state.prev_gray, new_gray, state.positions, state.alive)
    pos = flow.points
    alive = flow.valid

    # 2. PnP on tracked slots that own 3D points.
    tids = state.track_ids
    safe = torch.clamp(tids, 0, m.points.shape[0] - 1).long()
    has3d = alive & (tids >= 0) & m.point_valid[safe]
    X = m.points[safe]
    res = ransac.ransac_pnp(gen, X, pos, projection.normalize_points(pos, K), has3d, K,
                            threshold_px=thr, iters=rc.pnp_iters, use_p3p=rc.pnp_use_p3p,
                            sample_idx=sample_idx, sample_idx3=sample_idx3)
    pose_new = res.model
    m, cam_new = map_store.append_camera(m, pose_new)
    prev_cam = cam_new - 1
    pose_prev = m.poses[prev_cam.long()]
    m = map_store.append_observations(m, cam_new, tids, pos, res.inliers)

    # 3. Triangulate tracked slots without 3D (seen in both frames).
    fresh = alive & (tids < 0)
    X_new = triangulation.triangulate_euclidean(K @ pose_prev, K @ pose_new, state.positions, pos)
    d0, d1 = triangulation.triangulation_depths(pose_prev, pose_new, X_new)
    e0 = torch.linalg.norm(
        projection.reprojection_residuals(X_new, state.positions, pose_prev, K), dim=-1)
    e1 = torch.linalg.norm(projection.reprojection_residuals(X_new, pos, pose_new, K), dim=-1)
    good = fresh & (d0 > 0) & (d1 > 0) & (e0 < thr) & (e1 < thr)
    m, pids = map_store.append_points(m, X_new, _gray_colors(new_gray, pos), good)
    m = map_store.append_observations(m, prev_cam, pids, state.positions, good)
    m = map_store.append_observations(m, cam_new, pids, pos, good)
    tids = torch.where(good, pids.to(torch.int32), tids)
    # Slots that tracked keep their id (a PnP outlier may re-enter later);
    # slots that died lose it.
    tids = torch.where(alive, tids, torch.full_like(tids, -1))

    err = projection.masked_mean_reprojection_error(X, pos, pose_new, K, res.inliers)
    accepted = res.num_inliers >= rc.min_pnp_inliers
    new_state = KltState(map=m, prev_gray=new_gray, positions=pos, track_ids=tids, alive=alive)
    n_good = good.sum()
    stats = KltStats(num_tracked=alive.sum(), num_pnp_inliers=res.num_inliers,
                     num_new_points=torch.where(accepted, n_good, torch.zeros_like(n_good)),
                     reproj_error=err)
    return _select(accepted, new_state, state._replace(prev_gray=new_gray)), stats


def replenish(state: KltState, feats: Features, cfg: SfmConfig,
              min_dist: float = 8.0) -> KltState:
    """Fill dead slots with freshly detected keypoints away from live tracks,
    strongest response first. feats: detection on the current frame
    (``state.prev_gray``'s), with as many slots as the track table."""
    S = state.positions.shape[0]
    live_pos = torch.where(state.alive[:, None], state.positions,
                           torch.full_like(state.positions, 1e9))
    d2 = ((feats.xy ** 2).sum(1, keepdim=True) + (live_pos ** 2).sum(1)[None, :]
          - 2.0 * feats.xy @ live_pos.T)
    cand = feats.valid & (d2.min(1).values > min_dist ** 2)
    order = torch.argsort(torch.where(cand, -feats.response, torch.full_like(feats.response, 1e9)),
                          stable=True)
    dead_order = torch.argsort(state.alive.to(torch.int32), stable=True)  # dead first
    n_take = torch.minimum((~state.alive).sum(), cand.sum())
    take = torch.arange(S, device=cand.device) < n_take
    src = order[:S]
    dst = dead_order[:S]  # a permutation: every destination is distinct
    new_pos = torch.where(take[:, None], feats.xy[src], state.positions[dst])
    new_alive = torch.where(take, cand[src], state.alive[dst])
    new_tids = torch.where(take, torch.full_like(state.track_ids[dst], -1), state.track_ids[dst])
    return state._replace(positions=state.positions.index_copy(0, dst, new_pos),
                          alive=state.alive.index_copy(0, dst, new_alive),
                          track_ids=state.track_ids.index_copy(0, dst, new_tids))


class KltSfM:
    """Host driver for the KLT-tracking pipeline variant.

    Every tensor lives on `device` (default ``cuda``; without a GPU pass
    ``device="cpu"``).
    """

    def __init__(self, config: Optional[SfmConfig] = None, redetect_every: int = 5,
                 device="cuda"):
        self.config = config or SfmConfig()
        self.redetect_every = redetect_every
        self.device = resolve_device(device)
        self.stats: list[dict] = []

    def run(self, images_gray: Sequence[np.ndarray], seed: int = 0) -> MapState:
        """Bootstrap on frames 0 and 1, then track every later frame. Frame
        i's RANSAC draws come from a generator seeded from (seed, i)."""
        cfg = self.config
        dev = self.device
        K = torch.as_tensor(cfg.intrinsic_matrix(), device=dev)

        def gray(i):
            return torch.as_tensor(np.asarray(images_gray[i], np.float32), device=dev)

        g1 = gray(1)
        f0 = sift.detect_and_compute(gray(0), cfg.frontend)
        f1 = sift.detect_and_compute(g1, cfg.frontend)
        tv = bootstrap(frame_generator(dev, seed, 1), f0, f1, K, cfg)
        m = map_store.init_map(K, cfg.map)
        m, cam0 = map_store.append_camera(m, tv.pose0)
        m, cam1 = map_store.append_camera(m, tv.pose1)
        m, pids = map_store.append_points(m, tv.points, torch.zeros_like(tv.points), tv.valid)
        m = map_store.append_observations(m, cam0, pids, tv.uv0, tv.valid)
        m = map_store.append_observations(m, cam1, pids, tv.uv1, tv.valid)

        # The track table starts from frame 1's features; matched ones carry
        # their point ids (a repeated slot: the highest match wins, C1).
        S = cfg.frontend.max_features
        state = KltState(map=m, prev_gray=g1, positions=f1.xy,
                         track_ids=_track_vector(S, tv.idx1, tv.valid, pids), alive=f1.valid)
        for i in range(2, len(images_gray)):
            g = gray(i)
            state, st = klt_step(frame_generator(dev, seed, i), state, g, cfg)
            self.stats.append({
                "frame": i,
                "tracked": int(st.num_tracked),
                "pnp_inliers": int(st.num_pnp_inliers),
                "new_points": int(st.num_new_points),
                "reproj_error": float(st.reproj_error),
            })
            if i % self.redetect_every == 0 and i + 1 < len(images_gray):
                state = replenish(state, sift.detect_and_compute(g, cfg.frontend), cfg)
        self.state = state
        return state.map
