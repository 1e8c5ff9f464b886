"""View graph and loop closure: pairwise match strength, geometry and
re-observations between distant frames.

PyTorch port of ``sfm_mvs_tpu/models/exhaustive.py``: ``ViewGraph``,
``_pair_geometry``, ``build_view_graph`` and ``best_bootstrap_pair`` (every
frame pair within the window is matched and gets an E-RANSAC inlier
count, a relative pose and a parallax angle; the auto-bootstrap driver
picks its initial pair from them), and the loop closure of
``IncrementalSfM.finalize``: ``strongest_loop_pairs`` and
``inject_reobservations``. The JAX package matches these pairs with its
plain XLA matcher; here they go through the 2-NN kernel on CUDA tensors
(the same function; its wrapper takes the plain version for CPU tensors),
or the plain matcher with ``use_pallas_matcher=False``. The batched
stitching functions of that module (``inject_reobservations_batch`` and
the rest, which only ``benchmarks/large_scene.py`` calls) are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from sfm_mvs_tpu_torch.models import map_store
from sfm_mvs_tpu_torch.models.incremental import resolve_device
from sfm_mvs_tpu_torch.ops import matching, projection, ransac, sift
from sfm_mvs_tpu_torch.ops.epipolar import recover_pose
from sfm_mvs_tpu_torch.ops.matching_cuda import knn_match_cuda
from sfm_mvs_tpu_torch.ops.sift import Features
from sfm_mvs_tpu_torch.utils.config import SfmConfig


class ViewGraph(NamedTuple):
    """Pairwise geometry. F frames, M pairs (all, or those within the window)."""

    pair_i: np.ndarray  # (M,) first frame index per pair
    pair_j: np.ndarray  # (M,) second frame index
    num_matches: np.ndarray  # (M,) ratio-test survivors
    num_inliers: np.ndarray  # (M,) E-RANSAC inliers
    R: np.ndarray  # (M, 3, 3) relative rotations
    t: np.ndarray  # (M, 3) relative translations (unit)
    adjacency: np.ndarray  # (F, F) symmetric inlier-count matrix
    parallax_deg: np.ndarray  # (M,) mean rotation-compensated ray angle


def _match(f0: Features, f1: Features, cfg: SfmConfig) -> matching.Matches:
    """The pair's ratio-test matches: K1 (its wrapper takes the plain
    version on CPU tensors), or the plain matcher with use_pallas_matcher
    off."""
    fc = cfg.frontend
    match = knn_match_cuda if fc.use_pallas_matcher else matching.knn_match
    return match(f0.desc, f1.desc, f0.valid, f1.valid, ratio=fc.lowe_ratio)


def _pair_geometry(gen, f0: Features, f1: Features, K, cfg: SfmConfig):
    """Match + E-RANSAC + pose + parallax for one pair. Returns
    (num_matches, num_inliers, R, t, parallax_deg) as device tensors."""
    rc = cfg.ransac
    m = _match(f0, f1, cfg)
    n0 = projection.normalize_points(f0.xy[m.idx0.long()], K)
    n1 = projection.normalize_points(f1.xy[m.idx1.long()], K)
    res = ransac.ransac_essential(gen, n0, n1, m.valid, 0.5 * (K[0, 0] + K[1, 1]),
                                  threshold_px=rc.essential_threshold_px,
                                  iters=rc.essential_iters)
    R, t, _ = recover_pose(res.model, n0, n1, res.inliers)

    # Parallax: mean angle between the rotation-compensated ray from view 0
    # and the matching ray in view 1, over inliers. A zero-baseline pair
    # (the degenerate-bootstrap trap) scores many E-inliers but ~0 here.
    def rays(n):
        h = torch.cat([n, torch.ones_like(n[:, :1])], dim=1)
        return h / torch.linalg.norm(h, dim=1, keepdim=True)

    cosang = torch.clamp((rays(n0) @ R.T * rays(n1)).sum(1), -1.0, 1.0)
    ang = torch.rad2deg(torch.arccos(cosang))
    wsum = torch.clamp_min(res.inliers.sum(), 1)
    parallax = torch.where(res.inliers, ang, torch.zeros_like(ang)).sum() / wsum
    return m.valid.sum(), res.num_inliers, R, t, parallax


def build_view_graph(images_gray: Sequence[np.ndarray], cfg: Optional[SfmConfig] = None,
                     seed: int = 0, batch_size: int = 8,
                     feats: Optional[list[Features]] = None, window: int = 0,
                     device="cuda") -> ViewGraph:
    """Match frame pairs: all of them, or those with |i - j| <= window.

    Features are detected on `device` (default ``cuda``; without a GPU pass
    ``device="cpu"``) unless given (then their device is used). Pairs run
    in batches of `batch_size` whose results reach the host in one
    transfer; the RANSAC draws come from one generator seeded with `seed`.
    """
    cfg = cfg or SfmConfig()
    if feats is None:
        dev = resolve_device(device)
        feats = [sift.detect_and_compute(torch.as_tensor(np.asarray(g, np.float32), device=dev),
                                         cfg.frontend) for g in images_gray]
    dev = feats[0].xy.device
    K = torch.as_tensor(cfg.intrinsic_matrix(), device=dev)
    F = len(feats)
    pairs = [(i, j) for i in range(F) for j in range(i + 1, F) if not window or j - i <= window]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = []
    for s in range(0, len(pairs), batch_size):
        batch = [_pair_geometry(gen, feats[i], feats[j], K, cfg)
                 for i, j in pairs[s:s + batch_size]]
        out.append([torch.stack(list(col)).cpu().numpy() for col in zip(*batch)])
    nm, ni, R, t, px = (np.concatenate(col) for col in zip(*out))
    adjacency = np.zeros((F, F), dtype=np.int32)
    for (i, j), n in zip(pairs, ni):
        adjacency[i, j] = adjacency[j, i] = n
    return ViewGraph(
        pair_i=np.asarray([p[0] for p in pairs]), pair_j=np.asarray([p[1] for p in pairs]),
        num_matches=nm.astype(np.int32), num_inliers=ni.astype(np.int32), R=R, t=t,
        adjacency=adjacency, parallax_deg=px)


def best_bootstrap_pair(graph: ViewGraph, min_inliers: int = 50,
                        min_parallax_deg: float = 1.0, max_gap: int = 0) -> tuple[int, int]:
    """Pick the strongest non-degenerate pair to initialize from.

    Among pairs with enough inliers AND enough parallax, the highest inlier
    count wins; the parallax floor relaxes to a quarter, then to zero, if
    no pair passes. max_gap > 0 restricts to pairs at most that many
    frames apart.
    """
    order = np.argsort(-graph.num_inliers)
    gaps = np.abs(graph.pair_j - graph.pair_i)
    for required_px in (min_parallax_deg, 0.25 * min_parallax_deg, 0.0):
        for idx in order:
            if max_gap and gaps[idx] > max_gap:
                continue
            if (graph.num_inliers[idx] >= min_inliers
                    and graph.parallax_deg[idx] >= required_px):
                return int(graph.pair_i[idx]), int(graph.pair_j[idx])
    idx = order[0]
    return int(graph.pair_i[idx]), int(graph.pair_j[idx])


def strongest_loop_pairs(graph: ViewGraph, top_k: int, min_gap: int = 3,
                         min_inliers: int = 30) -> list[tuple[int, int]]:
    """The top-K strong non-adjacent pairs: loop-closure candidates whose
    re-observations tie distant cameras together before the final BA."""
    gaps = np.abs(graph.pair_j - graph.pair_i)
    cand = np.where((gaps >= min_gap) & (graph.num_inliers >= min_inliers))[0]
    cand = cand[np.argsort(-graph.num_inliers[cand])][:top_k]
    return [(int(graph.pair_i[i]), int(graph.pair_j[i])) for i in cand]


def _reobservation_candidates(state, cam_j, feats_i: Features, feats_j: Features,
                              track_i, cfg: SfmConfig, gen, max_err_px,
                              epipolar_verify: bool, sample_idx=None):
    """Match and gate one pair without writing: (tids, uv_j, ok, err), err
    the reprojection error in camera j."""
    rc = cfg.ransac
    m = _match(feats_i, feats_j, cfg)
    uv_i, uv_j, mvalid = matching.gather_match_points(feats_i.xy, feats_j.xy, m)
    if epipolar_verify:
        K = state.K
        n_i = projection.normalize_points(uv_i, K)
        n_j = projection.normalize_points(uv_j, K)
        res = ransac.ransac_essential(gen, n_i, n_j, mvalid, 0.5 * (K[0, 0] + K[1, 1]),
                                      threshold_px=rc.essential_threshold_px,
                                      iters=rc.essential_iters, sample_idx=sample_idx)
        # A real two-view geometry first: a spurious far pair yields a
        # degenerate E with few inliers.
        mvalid = mvalid & res.inliers & (res.num_inliers >= rc.stitch_min_inliers)
    gate_px = rc.pnp_threshold_px if max_err_px is None else max_err_px
    tids = track_i[m.idx0.long()]
    P = state.points.shape[0]
    safe = torch.clamp(tids, 0, P - 1).long()
    has = mvalid & (tids >= 0) & state.point_valid[safe]
    cam = torch.as_tensor(cam_j, device=safe.device).long()
    uv_proj, depth = projection.project_depth(state.points[safe], state.poses[cam], state.K)
    err = torch.linalg.norm(uv_proj - uv_j, dim=-1)
    fresh = ~state.obs_mask[safe, cam]
    return tids, uv_j, has & (depth > 0) & (err < gate_px) & fresh, err


def inject_reobservations(state, cam_i, cam_j, feats_i: Features, feats_j: Features,
                          track_i, cfg: SfmConfig, gen=None, max_err_px=None,
                          epipolar_verify: bool = False, sample_idx=None):
    """Add loop-closure observations: match the (non-adjacent) pair
    (cam_i, cam_j); wherever frame i's feature already tracks a map point,
    record that point's observation in camera j, gated by positive depth,
    the reprojection error and not being observed there yet. One
    direction: call twice with the arguments swapped for both.

    The default gate (`max_err_px=None`: cfg.ransac.pnp_threshold_px)
    accepts only matches that agree with the current geometry. For a
    drifted map pass `epipolar_verify=True` with a generator `gen` (or
    injected RANSAC samples `sample_idx`, (essential_iters, 8)): matches
    are verified by the pair's own E-RANSAC, a drift-independent check,
    and `max_err_px` should be loosened to a sanity bound, so that the
    global BA sees the bend and pulls it out. Returns (state, num_injected).
    """
    if epipolar_verify and gen is None and sample_idx is None:
        raise ValueError("epipolar_verify=True requires a generator")
    tids, uv_j, ok, _ = _reobservation_candidates(state, cam_j, feats_i, feats_j, track_i,
                                                  cfg, gen, max_err_px, epipolar_verify,
                                                  sample_idx)
    state = map_store.append_observations(state, cam_j, tids, uv_j, ok)
    return state, ok.sum()
