"""View graph and loop closure: pairwise match strength, geometry and
re-observations between distant frames.

PyTorch port of ``sfm_mvs_tpu/models/exhaustive.py``: ``ViewGraph``,
``_pair_geometry``, ``build_view_graph`` and ``best_bootstrap_pair`` (every
frame pair within the window is matched and gets an E-RANSAC inlier
count, a relative pose and a parallax angle; the auto-bootstrap driver
picks its initial pair from them), and the loop closure of
``IncrementalSfM.finalize``: ``strongest_loop_pairs`` and
``inject_reobservations``; and the split-phase loop stitching of
``benchmarks/large_scene.py``: ``covisibility_matrix`` and
``retrieve_stitch_pairs`` pick the pairs, ``stitch_candidates_batch``
matches and verifies a stack of them once (one batched 8-point E-RANSAC),
``apply_stitch_batch`` re-applies the candidates after every BA round, and
``inject_reobservations_batch`` does both in one call. The JAX package
matches these pairs with its plain XLA matcher; here they go through the
2-NN kernel on CUDA tensors (the same function; its wrapper takes the plain
version for CPU tensors), a stack of pairs in one batched launch, or the
plain matcher with ``use_pallas_matcher=False``. Batched scatters write
only the accepted entries, made distinct first, where the JAX package drops
the rest into an out-of-range row. The pair rankings sort stably: of pairs
with equal inlier counts the lower pair index comes first (the JAX package
leaves ties to numpy's default sort).

Traced (``utils/profiling.py``) as the span ``viewgraph`` around
:func:`build_view_graph` (counters ``viewgraph.pairs`` and
``viewgraph.useful_pairs``, the pairs with at least
:data:`LOOP_MIN_INLIERS` E-inliers), with ``viewgraph.match`` (K1 inside
it), ``viewgraph.essential`` and ``viewgraph.pose`` per pair and
``viewgraph.copy`` around each batch's transfer to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from sfm_mvs_tpu_torch.models import map_store
from sfm_mvs_tpu_torch.ops import matching, projection, ransac, sift
from sfm_mvs_tpu_torch.ops.epipolar import recover_pose
from sfm_mvs_tpu_torch.ops.matching_cuda import knn_match_cuda, knn_match_cuda_batch
from sfm_mvs_tpu_torch.ops.sift import Features
from sfm_mvs_tpu_torch.utils import profiling
from sfm_mvs_tpu_torch.utils.config import SfmConfig
from sfm_mvs_tpu_torch.utils.device import resolve_device

# The inlier floor of a loop-closure candidate (strongest_loop_pairs), and of
# a pair that the view graph's counter ``viewgraph.useful_pairs`` counts.
LOOP_MIN_INLIERS = 30


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
    with profiling.span("viewgraph.match"):
        m = _match(f0, f1, cfg)
    with profiling.span("viewgraph.essential"):
        n0 = projection.normalize_points(f0.xy[m.idx0.long()], K)
        n1 = projection.normalize_points(f1.xy[m.idx1.long()], K)
        res = ransac.ransac_essential(gen, n0, n1, m.valid, 0.5 * (K[0, 0] + K[1, 1]),
                                      threshold_px=rc.essential_threshold_px,
                                      iters=rc.essential_iters)
    with profiling.span("viewgraph.pose"):
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
    with profiling.span("viewgraph"):
        profiling.count("viewgraph.pairs", len(pairs))
        for s in range(0, len(pairs), batch_size):
            batch = [_pair_geometry(gen, feats[i], feats[j], K, cfg)
                     for i, j in pairs[s:s + batch_size]]
            with profiling.span("viewgraph.copy"):
                out.append([torch.stack(list(col)).cpu().numpy() for col in zip(*batch)])
            if profiling.enabled():  # on the host, after the copy: no device op, no sync
                profiling.count("viewgraph.useful_pairs",
                                int((out[-1][1] >= LOOP_MIN_INLIERS).sum()))
    nm, ni, R, t, px = (np.concatenate(col) for col in zip(*out))
    adjacency = np.zeros((F, F), dtype=np.int32)
    for (i, j), n in zip(pairs, ni):
        adjacency[i, j] = adjacency[j, i] = n
    return ViewGraph(
        pair_i=np.asarray([p[0] for p in pairs]), pair_j=np.asarray([p[1] for p in pairs]),
        num_matches=nm.astype(np.int32), num_inliers=ni.astype(np.int32), R=R, t=t,
        adjacency=adjacency, parallax_deg=px)


def bootstrap_candidates(graph: ViewGraph, min_inliers: int = 50,
                         min_parallax_deg: float = 1.0, max_gap: int = 0) -> list[tuple[int, int]]:
    """Every pair fit to initialize from, best first.

    First the pairs with enough inliers AND enough parallax, by inlier
    count (ties: the lower pair index first); then those that pass only
    with the parallax floor relaxed to a quarter, then to zero. max_gap > 0
    restricts to pairs at most that many frames apart. Where no pair has
    enough inliers, the strongest pair alone.
    """
    order = np.argsort(-graph.num_inliers, kind="stable")
    gaps = np.abs(graph.pair_j - graph.pair_i)
    out, seen = [], set()
    for required_px in (min_parallax_deg, 0.25 * min_parallax_deg, 0.0):
        for idx in order:
            if idx in seen or (max_gap and gaps[idx] > max_gap):
                continue
            if (graph.num_inliers[idx] >= min_inliers
                    and graph.parallax_deg[idx] >= required_px):
                seen.add(idx)
                out.append((int(graph.pair_i[idx]), int(graph.pair_j[idx])))
    if not out:
        idx = order[0]
        out.append((int(graph.pair_i[idx]), int(graph.pair_j[idx])))
    return out


def best_bootstrap_pair(graph: ViewGraph, min_inliers: int = 50,
                        min_parallax_deg: float = 1.0, max_gap: int = 0) -> tuple[int, int]:
    """Pick the strongest non-degenerate pair to initialize from: the first
    of :func:`bootstrap_candidates`.

    Among pairs with enough inliers AND enough parallax, the highest inlier
    count wins; the parallax floor relaxes to a quarter, then to zero, if
    no pair passes. max_gap > 0 restricts to pairs at most that many
    frames apart.
    """
    return bootstrap_candidates(graph, min_inliers, min_parallax_deg, max_gap)[0]


def strongest_loop_pairs(graph: ViewGraph, top_k: int, min_gap: int = 3,
                         min_inliers: int = LOOP_MIN_INLIERS) -> list[tuple[int, int]]:
    """The top-K strong non-adjacent pairs: loop-closure candidates whose
    re-observations tie distant cameras together before the final BA.
    Pairs at least `min_gap` frames apart with at least `min_inliers`
    inliers, by inlier count (ties: the lower pair index first)."""
    gaps = np.abs(graph.pair_j - graph.pair_i)
    cand = np.where((gaps >= min_gap) & (graph.num_inliers >= min_inliers))[0]
    cand = cand[np.argsort(-graph.num_inliers[cand], kind="stable")][:top_k]
    return [(int(graph.pair_i[i]), int(graph.pair_j[i])) for i in cand]


def pair_index(graph: ViewGraph, i: int, j: int) -> int:
    """The index of pair (i, j), i < j, in the graph's pair arrays."""
    hit = np.nonzero((graph.pair_i == i) & (graph.pair_j == j))[0]
    if not hit.size:
        raise KeyError(f"pair {(i, j)} is not in the view graph")
    return int(hit[0])


def pose_disagreement(pose0, pose1, R, t) -> tuple[float, float]:
    """How far the relative pose of two world->camera poses (3, 4) lies
    from a pair's (R, t) (unit t), in degrees, in float64 on the host:
    (the angle of the rotation between the two relative rotations, the
    angle between the two translation directions)."""
    p0 = np.asarray(torch.as_tensor(pose0).detach().cpu(), np.float64)
    p1 = np.asarray(torch.as_tensor(pose1).detach().cpu(), np.float64)
    R_rel = p1[:, :3] @ p0[:, :3].T
    t_rel = p1[:, 3] - R_rel @ p0[:, 3]
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    cos_r = np.clip((np.trace(R_rel @ R.T) - 1.0) / 2.0, -1.0, 1.0)
    nt = np.linalg.norm(t_rel) * np.linalg.norm(t)
    cos_t = np.clip(float(t_rel @ t) / nt, -1.0, 1.0) if nt > 0 else -1.0
    return float(np.degrees(np.arccos(cos_r))), float(np.degrees(np.arccos(cos_t)))


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


def _match_batch(feats_i: Features, feats_j: Features, pair_valid, cfg: SfmConfig):
    """(B, M) matches of B stacked pairs: one batched K1 launch
    (``knn_match_cuda_batch``; the plain batched matcher on CPU tensors or
    with use_pallas_matcher off). Pad rows (pair_valid False) come back all
    invalid, with idx1 0."""
    fc = cfg.frontend
    match = knn_match_cuda_batch if fc.use_pallas_matcher else matching.knn_match
    m = match(feats_i.desc, feats_j.desc, feats_i.valid, feats_j.valid, ratio=fc.lowe_ratio)
    live = pair_valid.to(torch.bool)[:, None]
    return m._replace(idx1=torch.where(live, m.idx1, torch.zeros_like(m.idx1)),
                      valid=m.valid & live)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for every row b: x (B, F, ...), idx (B, M)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.long()]


def _match_points_batch(feats_i: Features, feats_j: Features, m: matching.Matches):
    """Batched ``matching.gather_match_points``: (uv_i, uv_j, valid), (B, M)."""
    v = m.valid[..., None]
    zero = torch.zeros((), dtype=feats_i.xy.dtype, device=feats_i.xy.device)
    return (torch.where(v, _gather_rows(feats_i.xy, m.idx0), zero),
            torch.where(v, _gather_rows(feats_j.xy, m.idx1), zero), m.valid)


def _write_observations(state, ok, tids, cam, uv):
    """obs_uv / obs_mask written at (tids[b, m], cam[b]) for every ok entry
    (the JAX package scatters the rest into an out-of-range row with
    mode="drop"). The targets must be distinct (_dedup_scatter_targets)."""
    b, k = torch.nonzero(ok & (tids >= 0), as_tuple=True)
    p, c = tids[b, k].long(), cam.long()[b]
    obs_uv = state.obs_uv.index_put((p, c), uv[b, k])
    obs_mask = state.obs_mask.index_put((p, c), torch.ones_like(p, dtype=torch.bool))
    return state._replace(obs_uv=obs_uv, obs_mask=obs_mask)


def _gate(state, cam, tids, uv, ok, gate_px):
    """Map gates of B candidate rows against camera cam[b]: live point,
    positive depth, reprojection error under gate_px, not yet observed
    there. Returns (ok, err)."""
    P = state.points.shape[0]
    safe = torch.clamp(tids, 0, P - 1).long()
    has = ok & (tids >= 0) & state.point_valid[safe]
    uv_proj, depth = projection.project_depth(state.points[safe], state.poses[cam], state.K)
    err = torch.linalg.norm(uv_proj - uv, dim=-1)
    fresh = ~state.obs_mask[safe, cam[:, None]]
    return has & (depth > 0) & (err < gate_px) & fresh, err


def inject_reobservations_batch(state, cam_js, feats_i: Features, feats_j: Features, tracks_i,
                                pair_valid, cfg: SfmConfig, gen=None, max_err_px=None,
                                epipolar_verify: bool = False, sample_idx=None):
    """Batched :func:`inject_reobservations`: B pairs, one direction each.

    feats_*: Features with a leading (B,) axis; tracks_i: (B, F); cam_js:
    (B,); pair_valid: (B,) (pad rows False). With `epipolar_verify`, one
    ``ransac_essential_batch`` verifies every pair (draws from `gen`, or
    injected samples `sample_idx`, (B, essential_iters, 8)). Duplicate
    targets are resolved by ``_dedup_scatter_targets``: rows sharing a
    camera keep the lowest row, matches sharing a track id within a row the
    lowest reprojection error. Returns (state, per-pair injected counts (B,)).
    """
    rc = cfg.ransac
    if epipolar_verify and gen is None and sample_idx is None:
        raise ValueError("epipolar_verify=True requires a generator")
    pair_valid = torch.as_tensor(pair_valid, device=feats_i.valid.device)
    m = _match_batch(feats_i, feats_j, pair_valid, cfg)
    uv_i, uv_j, mvalid = _match_points_batch(feats_i, feats_j, m)
    K = state.K
    if epipolar_verify:
        res = ransac.ransac_essential_batch(
            gen, projection.normalize_points(uv_i, K), projection.normalize_points(uv_j, K),
            mvalid, 0.5 * (K[0, 0] + K[1, 1]), threshold_px=rc.essential_threshold_px,
            iters=rc.essential_iters, sample_idx=sample_idx)
        mvalid = mvalid & res.inliers & (res.num_inliers >= rc.stitch_min_inliers)[:, None]
    gate_px = rc.pnp_threshold_px if max_err_px is None else max_err_px
    tids = _gather_rows(tracks_i, m.idx0)
    C = state.poses.shape[0]
    cam = torch.clamp(torch.as_tensor(cam_js, device=K.device), 0, C - 1).long()
    ok, err = _gate(state, cam, tids, uv_j, mvalid, gate_px)
    ok = ok & pair_valid[:, None]
    ok = _dedup_scatter_targets(ok, tids, err, cam, state.points.shape[0], C)
    return _write_observations(state, ok, tids, cam, uv_j), ok.sum(1)


class StitchCandidates(NamedTuple):
    """Verified (match + pair-local E-RANSAC) stitch candidates of a batch
    of pairs, in both directions. Re-applying them against updated map
    geometry (apply_stitch_batch) costs a projection gate and a scatter, so
    a stitch <-> robust-BA alternation pays for matching and RANSAC once."""

    cam_a: torch.Tensor  # (B,) destination cameras, direction i -> j
    tids_a: torch.Tensor  # (B, M) map point ids (tracks_i at idx0)
    uv_a: torch.Tensor  # (B, M, 2) observation pixels in cam_a
    cam_b: torch.Tensor  # (B,) destination cameras, direction j -> i
    tids_b: torch.Tensor  # (B, M)
    uv_b: torch.Tensor  # (B, M, 2)
    ok: torch.Tensor  # (B, M) epipolar-verified match mask (shared)


def stitch_candidates_batch(state, cam_is, cam_js, feats_i: Features, feats_j: Features,
                            tracks_i, tracks_j, pair_valid, cfg: SfmConfig, gen=None,
                            sample_idx=None) -> StitchCandidates:
    """Match and epipolar-verify B pairs; both injection directions come
    from the one match set. One batched K1 launch matches the stack, then one
    ``ransac_essential_batch`` (8-point, essential_iters) verifies the
    stack: draws from `gen`, or injected samples `sample_idx` (B, iters, 8).

    feats_*: Features with a leading (B,) axis; tracks_*: (B, F); cam_*:
    (B,); pair_valid: (B,). No map gate here (apply_stitch_batch), so the
    candidates stay valid across BA rounds.
    """
    rc = cfg.ransac
    pair_valid = torch.as_tensor(pair_valid, device=feats_i.valid.device)
    m = _match_batch(feats_i, feats_j, pair_valid, cfg)
    uv_i, uv_j, mvalid = _match_points_batch(feats_i, feats_j, m)
    K = state.K
    res = ransac.ransac_essential_batch(
        gen, projection.normalize_points(uv_i, K), projection.normalize_points(uv_j, K),
        mvalid, 0.5 * (K[0, 0] + K[1, 1]), threshold_px=rc.essential_threshold_px,
        iters=rc.essential_iters, sample_idx=sample_idx)
    enough = res.num_inliers >= rc.stitch_min_inliers
    ok = mvalid & res.inliers & enough[:, None] & pair_valid[:, None]
    return StitchCandidates(
        cam_a=torch.as_tensor(cam_js, device=K.device), tids_a=_gather_rows(tracks_i, m.idx0),
        uv_a=uv_j, cam_b=torch.as_tensor(cam_is, device=K.device),
        tids_b=_gather_rows(tracks_j, m.idx1), uv_b=uv_i, ok=ok)


def apply_stitch_batch(state, cam_dst, tids, uv, ok_epi, gate_px):
    """Map-gated injection of pre-verified candidates, one direction.

    Gates: live point, positive depth, reprojection error under gate_px
    against the current geometry, not yet observed. Cheap (projection and
    scatter), so it can run again after every BA round. Destinations are
    made distinct first (``_dedup_scatter_targets``): rows sharing a camera
    keep the lowest row, matches sharing a track id the lowest error.
    Returns (state, per-pair injected counts (B,)).
    """
    P, C = state.obs_mask.shape
    cam = torch.clamp(torch.as_tensor(cam_dst, device=tids.device), 0, C - 1).long()
    ok, err = _gate(state, cam, tids, uv, ok_epi, gate_px)
    ok = _dedup_scatter_targets(ok, tids, err, cam, P, C)
    return _write_observations(state, ok, tids, cam, uv), ok.sum(1)


def _dedup_scatter_targets(ok, tids, err, cam_dst, P: int, C: int):
    """Make batched (point, camera) scatter destinations distinct.

    (a) Across rows: among rows with any valid candidate sharing a
    destination camera, the lowest row index wins (the rest are masked).
    (b) Within a row: among valid matches sharing a track id, the lowest
    `err` wins; ties go to the lowest match index (a stable lexsort: by err,
    then stably by track id).
    """
    B, M = tids.shape
    dev = tids.device
    row_idx = torch.arange(B, device=dev)
    cam_key = torch.where(ok.any(1), torch.clamp(cam_dst.long(), 0, C - 1),
                          torch.full_like(row_idx, C))
    winner = torch.full((C + 1,), B, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(0, cam_key, row_idx, reduce="amin")
    ok = ok & (winner[cam_key] == row_idx)[:, None]

    key_t = torch.where(ok, tids.long(), torch.full_like(tids, P).long())  # masked: last
    by_err = torch.argsort(err, dim=1, stable=True)
    order = torch.gather(by_err, 1, torch.argsort(torch.gather(key_t, 1, by_err), dim=1,
                                                  stable=True))
    st = torch.gather(key_t, 1, order)
    first = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                       st[:, 1:] != st[:, :-1]], dim=1)
    return ok & torch.zeros_like(ok).scatter(1, order, first)


def covisibility_matrix(state, image_size: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """(C, C) int32 covisibility counts from the current map, the retrieval
    signal of stitch-pair selection: cnt[i, j] is the number of points
    camera i observes that project inside camera j's image at positive
    depth. One (C, P) x (P, C) FP32 product (TF32 off), exact up to 2^24.

    image_size: (W, H) of the cameras' images; without it W = 2 cx and
    H = 2 cy, which is wrong for an off-centre principal point.
    """
    pts = state.points
    R = state.poses[:, :, :3]
    t = state.poses[:, :, 3]
    Xc = torch.einsum("cij,pj->cpi", R, pts) + t[:, None, :]
    z = Xc[..., 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    K = state.K
    u = Xc[..., 0] / zs * K[0, 0] + K[0, 2]
    v = Xc[..., 1] / zs * K[1, 1] + K[1, 2]
    if image_size is not None:
        W, H = float(image_size[0]), float(image_size[1])
    else:
        W, H = 2.0 * K[0, 2], 2.0 * K[1, 2]
    sees = ((z > 0.0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
            & state.point_valid[None, :] & state.cam_valid[:, None])  # (C, P)
    obs = (state.obs_mask & state.point_valid[:, None]).to(torch.float32)
    return (obs.T @ sees.T.to(torch.float32)).to(torch.int32)


def retrieve_stitch_pairs(cnt: np.ndarray, n_cams: int, min_gap: int = 4, min_covis: int = 48,
                          octaves: tuple = ((4, 8), (8, 16), (16, 32), (32, 64), (64, 1 << 30))):
    """Stitch pairs from the covisibility matrix (host numpy).

    For each camera j, at most one partner i < j per distance octave: the
    farthest covisible camera in the bucket (long links straighten drift;
    short ones densify local tracks). Pairs that do not overlap are never
    matched. Returns a list of (i, j), i < j, without repeats.
    """
    pairs = []
    for j in range(n_cams):
        for lo, hi in octaves:
            cands = [i for i in range(max(0, j - min(hi - 1, j)), j - lo + 1)
                     if (j - i) >= max(lo, min_gap) and cnt[i, j] >= min_covis]
            if cands:
                pairs.append((min(cands), j))
    seen = set()
    out = []
    for p in pairs:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out
