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
import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from sfm_mvs_tpu_torch.models import ba as ba_mod
from sfm_mvs_tpu_torch.models import densify, map_store
from sfm_mvs_tpu_torch.models.map_store import MapState
from sfm_mvs_tpu_torch.models.refine import finalize_map
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
                        cfg: SfmConfig, return_track0: bool = False):
    """Run the two-view bootstrap and materialize the initial map.

    Returns (PipelineState, FrameStats), and with `return_track0` also the
    track-id vector of frame 0's feature slots.
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
    pstate = PipelineState(map=state, prev_feats=feats1, prev_track=track)
    if return_track0:
        return pstate, stats, _track_vector(feats0.xy.shape[0], tv.idx0, tv.valid, pids)
    return pstate, stats


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
                   cfg: SfmConfig, anchor_cam=None):
    """Register one new frame against the map, matched to the frame whose
    features are ``pstate.prev_feats``.

    anchor_cam: camera id of that frame. Defaults to the most recently
    appended camera (the sequential sliding window); the auto-bootstrap
    driver passes it, since its registration order walks away from the
    bootstrap pair in both directions. Returns (PipelineState, FrameStats);
    a frame with too few PnP inliers is rejected and the input state
    returned unchanged.
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
    prev_cam = cam_new - 1 if anchor_cam is None else torch.as_tensor(
        anchor_cam, dtype=cam_new.dtype, device=cam_new.device)
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


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a usable GPU raises
    (the Python API runs on the card unless the caller asks for the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: CUDA is not available on this machine "
                           "(pass device=\"cpu\" to run on the CPU)")
    return dev


def frame_generator(device, seed: int, frame: int) -> torch.Generator:
    """The random stream of one frame: a generator seeded from (seed, frame).

    Frame i draws the same numbers whether the run started at frame 0 or
    resumed from a checkpoint (the JAX driver re-splits its key for the
    same effect).
    """
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, frame]).generate_state(1, np.uint64)[0]))
    return gen


class IncrementalSfM:
    """Host-side driver: detect -> bootstrap/register -> optional BA, frame
    by frame, then ``finalize``.

    Every tensor lives on `device` (default ``cuda``; without a GPU pass
    ``device="cpu"``). The JAX package's ``IncrementalSfM``:
    the sequential bootstrap on frames (0, 1) or the view-graph bootstrap
    (``bootstrap="auto"``), bundle adjustment every ``cfg.ba.cadence``
    frames (global or windowed), a checkpoint every ``checkpoint_every``
    frames and resume from one, per-frame records to ``metrics`` (a
    ``utils.metrics.MetricsLogger``), and ``finalize`` (compact, loop
    closure, cull + global BA with duplicate merging, the densification
    sweep, BA of the intrinsics).
    """

    def __init__(self, config: Optional[SfmConfig] = None, device="cuda", metrics=None,
                 checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0):
        self.config = config or SfmConfig()
        self.device = resolve_device(device)
        self.metrics = metrics
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.stats: list[dict] = []

    def _maybe_ba(self, pstate: PipelineState, frame: int) -> PipelineState:
        # As in the JAX package, BaConfig's damping fields are not passed on:
        # run_ba's defaults apply (ROADMAP C4).
        cfg = self.config
        if not cfg.ba.enabled:
            return pstate
        if cfg.ba.cadence > 1 and (frame % cfg.ba.cadence) != 0:
            return pstate
        if cfg.ba.local_window > 0:
            mstate, ba_stats = ba_mod.bundle_adjust_window(
                pstate.map, window_cams=cfg.ba.local_window,
                window_points=cfg.ba.window_points,
                max_iterations=cfg.ba.max_iterations, huber_delta=cfg.ba.huber_delta)
        else:
            mstate, ba_stats = ba_mod.bundle_adjust_map(
                pstate.map, max_iterations=cfg.ba.max_iterations,
                huber_delta=cfg.ba.huber_delta)
        if self.metrics is not None:
            self.metrics.log(event="ba", frame=frame,
                             initial_cost=float(ba_stats.initial_cost),
                             final_cost=float(ba_stats.final_cost),
                             accepted=int(ba_stats.accepted))
        return pstate._replace(map=mstate)

    def _maybe_checkpoint(self, pstate: PipelineState, frame: int) -> None:
        if not self.checkpoint_dir or not self.checkpoint_every:
            return
        if frame % self.checkpoint_every == 0:
            from sfm_mvs_tpu_torch.utils import checkpoint as ckpt

            ckpt.save_pipeline(f"{self.checkpoint_dir}/frame_{frame:05d}.npz", pstate, frame)

    def run(self, images_gray: Sequence[np.ndarray],
            images_bgr: Optional[Sequence[np.ndarray]] = None, seed: int = 0,
            resume_state: Optional[PipelineState] = None, resume_frame: int = 0,
            batch_detect: int = 0) -> MapState:
        """Reconstruct from an ordered image sequence.

        images_gray: list of (H, W) float32 in [0, 1]. images_bgr: optional
        matching (H, W, 3) color images for point colors; grayscale is
        replicated when absent. resume_state/resume_frame: continue a
        checkpointed run (``utils.checkpoint.load_pipeline``); frames up to
        and including `resume_frame` are skipped. batch_detect > 0:
        detect every frame before the registration loop, in chunks of this
        size. Per-frame stats go to ``self.stats`` (and ``self.metrics``).
        """
        cfg = self.config
        dev = self.device
        K = torch.as_tensor(cfg.intrinsic_matrix(), device=dev)
        if images_bgr is None:
            images_bgr = [np.repeat((g * 255.0)[..., None], 3, axis=-1) for g in images_gray]

        def detect(i):
            img = torch.as_tensor(np.asarray(images_gray[i], np.float32), device=dev)
            return sift.detect_and_compute(img, cfg.frontend)

        pre_feats: Optional[list] = None
        if batch_detect > 0:
            # The JAX package vmaps each chunk; a batched SIFT is later work,
            # so a chunk is detected frame by frame (the same features).
            pre_feats = []
            for s in range(0, len(images_gray), batch_detect):
                pre_feats += [detect(i) for i in range(s, min(s + batch_detect, len(images_gray)))]

        def get_feats(i):
            f = pre_feats[i] if pre_feats is not None else detect(i)
            # Undistort once at detection time so the stored per-camera
            # features (the densify sweep) and the map agree.
            return _undistort_features(f, K, cfg)

        # Per registered camera (rejected frames excluded): features and
        # images for finalize's loop closure and densification sweep, and
        # feature-slot -> point-id track vectors, which finalize keeps
        # remapped.
        self._cam_feats, self._cam_bgr, self._cam_gray, self._cam_tracks = [], [], [], []
        if cfg.bootstrap == "auto" and resume_state is None:
            if self.checkpoint_dir and self.checkpoint_every:
                warnings.warn(
                    "bootstrap=auto registers frames out of order; periodic "
                    "checkpoints are not written (resume would fall back to "
                    "the sequential driver). Run without --checkpoint-every "
                    "or with --bootstrap seq.")
            return self._run_auto(images_gray, images_bgr, seed, get_feats)
        if resume_state is not None and cfg.bootstrap == "auto":
            warnings.warn("resuming with bootstrap=auto: continuing with the "
                          "SEQUENTIAL driver from the checkpointed state")
        if resume_state is not None:
            pstate = type(resume_state)(*[
                type(v)(*[a.to(dev) for a in v]) if isinstance(v, tuple) else v.to(dev)
                for v in resume_state])
            start = resume_frame + 1
        else:
            t0 = time.perf_counter()
            feats = [get_feats(0), get_feats(1)]
            pstate, st, track0 = init_from_bootstrap(
                frame_generator(dev, seed, 1), feats[0], feats[1], self._bgr(images_bgr[1]),
                K, cfg, return_track0=True)
            self._record(1, st, self._wait(t0))
            self._cam_feats += feats
            self._cam_bgr += [images_bgr[0], images_bgr[1]]
            self._cam_gray += [images_gray[0], images_gray[1]]
            self._cam_tracks += [track0, pstate.prev_track]
            start = 2
        for i in range(start, len(images_gray)):
            t0 = time.perf_counter()
            f = get_feats(i)
            pstate, st = register_frame(frame_generator(dev, seed, i), pstate, f,
                                        self._bgr(images_bgr[i]), cfg)
            pstate = self._maybe_ba(pstate, i)
            self._record(i, st, self._wait(t0))
            if bool(st.accepted):
                self._cam_feats.append(f)
                self._cam_bgr.append(images_bgr[i])
                self._cam_gray.append(images_gray[i])
                self._cam_tracks.append(pstate.prev_track)
            self._maybe_checkpoint(pstate, i)
        self.state = pstate
        return pstate.map

    def _run_auto(self, images_gray, images_bgr, seed, get_feats) -> MapState:
        """View-graph-driven registration: bootstrap on the strongest
        sufficient-parallax pair, then register the remaining frames walking
        outward from it. Cameras are re-permuted into frame order at the
        end, so export, evaluation and the sweep see the usual layout."""
        from sfm_mvs_tpu_torch.models import exhaustive

        cfg = self.config
        dev = self.device
        K = torch.as_tensor(cfg.intrinsic_matrix(), device=dev)
        N = len(images_gray)
        feats = [get_feats(i) for i in range(N)]
        graph = exhaustive.build_view_graph(images_gray, cfg, seed=seed, feats=feats,
                                            window=cfg.view_graph_window)
        a, b = exhaustive.best_bootstrap_pair(graph)
        if a > b:
            a, b = b, a
        if self.metrics is not None:
            self.metrics.log(event="bootstrap_auto", pair=[a, b])
        pstate, st, track_a = init_from_bootstrap(
            frame_generator(dev, seed, b), feats[a], feats[b], self._bgr(images_bgr[b]), K, cfg,
            return_track0=True)
        self._record(b, st, 0.0)
        state = pstate.map
        tracks = {a: track_a, b: pstate.prev_track}
        cam_of_frame = {a: 0, b: 1}
        frame_of_cam = [a, b]

        # Walks: forward past b, backward before a, and the a..b interior.
        walks = [(range(b + 1, N), b), (range(a - 1, -1, -1), a), (range(a + 1, b), a)]
        step = 1
        for frames, anchor in walks:
            for f in frames:
                t0 = time.perf_counter()
                pstate_f = PipelineState(map=state, prev_feats=feats[anchor],
                                         prev_track=tracks[anchor])
                new_pstate, st = register_frame(
                    frame_generator(dev, seed, f), pstate_f, feats[f],
                    self._bgr(images_bgr[f]), cfg, anchor_cam=cam_of_frame[anchor])
                new_pstate = self._maybe_ba(new_pstate, step)
                self._record(f, st, self._wait(t0))
                if bool(st.accepted):
                    state = new_pstate.map
                    tracks[f] = new_pstate.prev_track
                    cam_of_frame[f] = len(frame_of_cam)
                    frame_of_cam.append(f)
                    anchor = f
                step += 1

        # Restore frame order for export, evaluation and the sweep.
        state = map_store.reorder_cameras(state, np.argsort(frame_of_cam))
        frames_sorted = sorted(frame_of_cam)
        self._cam_feats = [feats[f] for f in frames_sorted]
        self._cam_bgr = [images_bgr[f] for f in frames_sorted]
        self._cam_gray = [images_gray[f] for f in frames_sorted]
        self._cam_tracks = [tracks[f] for f in frames_sorted]
        self.bootstrap_pair = (a, b)
        last = frames_sorted[-1]
        self.state = PipelineState(map=state, prev_feats=feats[last], prev_track=tracks[last])
        return state

    def finalize(self, cull_px: float = 4.0, compact: bool = True,
                 ba_iterations: int = 0) -> MapState:
        """Final polish, in the JAX package's order: capacity right-sizing;
        loop closure (cfg.loop_close_pairs > 0: the full view graph over the
        registered cameras, its strongest non-adjacent pairs, epipolar-
        verified re-observations injected both ways); cull + global BA,
        preceded by a robust BA and duplicate merging when loop closures
        were injected; the densification sweep (cfg.sweep.enabled); and
        last, BA of the intrinsics (cfg.ba.refine_intrinsics or
        refine_intrinsics_per_camera). Updates and returns the map; what it
        did goes to ``self.finalize_info``.

        compact: BA cost on the dense grid is capacity-proportional, so the
        map is compacted and shrunk to the smallest power of two (from 1024)
        holding 1.25x its live points before the global solves; the stored
        track vectors are remapped.
        """
        if ba_iterations <= 0:
            ba_iterations = 20
        cfg = self.config
        state = self.state.map
        if compact:
            state, remap = map_store.compact_points(state)
            live = int(state.num_points)
            cap = 1024
            while cap < int(1.25 * live):
                cap *= 2
            state = map_store.shrink_map(state, cap)
            P_new = state.points.shape[0]

            def _remap(t):
                new = torch.where(t >= 0, remap[torch.clamp(t, 0, remap.shape[0] - 1).long()],
                                  torch.full_like(t, -1))
                return torch.where(new < P_new, new, torch.full_like(new, -1))

            self._cam_tracks = [_remap(t) for t in self._cam_tracks]
            self.state = self.state._replace(map=state, prev_track=_remap(self.state.prev_track))

        n_closed = 0
        if cfg.loop_close_pairs > 0 and len(self._cam_tracks) == int(state.num_cams):
            state, n_closed = self._close_loops(state)
            self.state = self.state._replace(map=state)

        # Loop closures can re-associate a landmark that exists as two track
        # chains: merge duplicates within ~2 px at the median depth, once the
        # robust phase has pulled them into agreement.
        merge_eps = 0.0
        if n_closed:
            pose0 = state.poses[0]
            z = state.points @ pose0[2, :3] + pose0[2, 3]
            z_med = float(np.median(z[state.point_valid].cpu().numpy()))  # numpy's even-count mean
            merge_eps = 2.0 * max(z_med, 1e-3) / float(state.K[0, 0])
        state, info = finalize_map(
            state, max_iterations=ba_iterations, cull_px=cull_px,
            # Loop-closure observations may carry large (drift-revealing)
            # errors: relax robustly before the cull can delete them.
            robust_iterations=30 if n_closed else 0, merge_eps_3d=merge_eps)
        if n_closed:
            info["loop_closure_obs"] = n_closed
        merge_remap = info.pop("point_remap", None)
        if merge_remap is not None:
            # Re-point the stored track ids at the merged survivors (they
            # feed the sweep below and any resumed registration).
            def _remap_merged(t):
                safe = torch.clamp(t, 0, merge_remap.shape[0] - 1).long()
                return torch.where(t >= 0, merge_remap[safe], torch.full_like(t, -1))

            self._cam_tracks = [_remap_merged(t) for t in self._cam_tracks]
            self.state = self.state._replace(prev_track=_remap_merged(self.state.prev_track))

        aligned = len(self._cam_feats) == int(state.num_cams)
        if cfg.sweep.enabled and not aligned:
            warnings.warn("densification sweep skipped: stored per-camera features "
                          "do not cover all registered cameras")
        if cfg.sweep.enabled and aligned:
            state, sweep_info = densify.finalize_with_sweep(
                state, self._cam_feats, self._cam_bgr, cfg,
                cull_px=cull_px, images_gray=self._cam_gray)
            info.update(sweep_info)
        if cfg.ba.refine_intrinsics or cfg.ba.refine_intrinsics_per_camera:
            # Last, so that the recovered [s, k1, k2] describe the exported
            # map (the sweep's pinhole solves would undo part of them).
            if cfg.ba.refine_intrinsics_per_camera:
                state, ba_stats, intr = ba_mod.bundle_adjust_map_percam_intrinsics(
                    state, max_iterations=ba_iterations)
                n = int(state.num_cams)
                info["intrinsics_per_camera"] = [[float(v) for v in row]
                                                 for row in intr[:n].cpu().numpy()]
            else:
                state, ba_stats, intr = ba_mod.bundle_adjust_map_intrinsics(
                    state, max_iterations=ba_iterations)
                info["intrinsics"] = [float(v) for v in intr.cpu().numpy()]
            info["final_cost"] = float(ba_stats.final_cost)
        if self.metrics is not None:
            self.metrics.log(event="finalize", **info)
        self.finalize_info = info
        self.state = self.state._replace(map=state)
        return state

    def _close_loops(self, state: MapState):
        """Camera-aligned view graph (every pair) -> the strongest
        non-adjacent pairs -> re-observations injected both ways, verified
        by each pair's own E-RANSAC under the loose stitch gate (on a
        drifted map the default map-agreement gate rejects exactly the
        matches that reveal the drift). The RANSAC draws come from a
        generator seeded with the camera count, so a resumed run replays
        them. Returns (state, observations injected)."""
        from sfm_mvs_tpu_torch.models import exhaustive

        cfg = self.config
        graph = exhaustive.build_view_graph(self._cam_gray, cfg, feats=self._cam_feats)
        pairs = exhaustive.strongest_loop_pairs(graph, cfg.loop_close_pairs)
        gen = torch.Generator(device=state.points.device)
        gen.manual_seed(int(state.num_cams))
        n_closed = 0
        for i, j in pairs:
            for a, b in ((i, j), (j, i)):
                state, n = exhaustive.inject_reobservations(
                    state, a, b, self._cam_feats[a], self._cam_feats[b], self._cam_tracks[a],
                    cfg, gen=gen, max_err_px=cfg.map.stitch_gate_px, epipolar_verify=True)
                n_closed += int(n)
        return state, n_closed

    def _bgr(self, image) -> torch.Tensor:
        return torch.as_tensor(np.asarray(image, np.float32), device=self.device)

    def _wait(self, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _record(self, frame: int, st: FrameStats, wall_s: float) -> None:
        d = {
            "frame": frame,
            "matches": int(st.num_matches),
            "tracked": int(st.num_tracked),
            "pnp_inliers": int(st.num_pnp_inliers),
            "new_points": int(st.num_new_points),
            "reproj_error": float(st.reproj_error),
            "accepted": bool(st.accepted),
            "wall_s": wall_s,
        }
        self.stats.append(d)
        if self.metrics is not None:
            self.metrics.log(event="frame", **d)
