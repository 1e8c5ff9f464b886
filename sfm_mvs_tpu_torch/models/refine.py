"""Map refinement: outlier culling + final global bundle adjustment.

PyTorch port of ``sfm_mvs_tpu/models/refine.py``: drop observations whose
reprojection error exceeds a threshold, drop points left with fewer than
two observations, then run a global BA; all masked grid math.
"""

from __future__ import annotations

import torch

from sfm_mvs_tpu_torch.models import ba as ba_mod
from sfm_mvs_tpu_torch.models import map_store
from sfm_mvs_tpu_torch.models.map_store import MapState
from sfm_mvs_tpu_torch.utils import profiling


def cull_map(state: MapState, max_error_px: float = 4.0, min_track: int = 2) -> MapState:
    """Invalidate bad observations and under-supported points.

    Observation (p, c) is dropped when its reprojection error reaches
    `max_error_px`; point p when fewer than `min_track` observations remain.
    """
    prob = ba_mod.problem_from_map(state)
    r = ba_mod._res_grid(prob.cam_params, prob.points, prob.obs_uv, prob.K)
    err = torch.linalg.norm(r, dim=-1)  # (P, C)
    obs_ok = (ba_mod._weights(prob) > 0) & (err < max_error_px)
    point_ok = state.point_valid & (obs_ok.sum(1) >= min_track)
    return state._replace(obs_mask=obs_ok & point_ok[:, None], point_valid=point_ok)


def finalize_map(state: MapState, max_iterations: int = 20, cull_px: float = 4.0,
                 rounds: int = 2, robust_iterations: int = 0,
                 robust_huber_px: float = 3.0, cg_iters: int = 20,
                 merge_eps_3d: float = 0.0, merge_px: float = 4.0):
    """Cull -> global BA, repeated `rounds` times (the final polish).

    robust_iterations > 0 first runs a Huber-robustified global BA before
    any cull, so that large-error long-range observations pull the
    trajectory straight instead of being culled. merge_eps_3d > 0 then
    collapses duplicate landmarks (``map_store.merge_duplicate_points``,
    two passes: pairs, then clusters) before the cull rounds; the composed
    point-id remap goes to ``info["point_remap"]`` (callers holding track
    ids re-point them at the survivors) and the count to
    ``info["merged_points"]``. Returns (MapState, info).

    Traced in the spans ``finalize.robust`` (the robust BA),
    ``finalize.merge`` (counter ``finalize.merged``) and ``finalize.cull``
    (each round's cull and BA); BA keeps its own ``ba`` spans.
    """
    info = {}
    if robust_iterations > 0:
        with profiling.span("finalize.robust"):
            state, stats = ba_mod.bundle_adjust_map(
                state, max_iterations=robust_iterations, cg_iters=cg_iters,
                huber_delta=robust_huber_px)
            info["robust_cost"] = float(stats.final_cost)
    if merge_eps_3d > 0.0:
        with profiling.span("finalize.merge"):
            n_total, remap_total = 0, None
            for _ in range(2):
                state, remap, n = map_store.merge_duplicate_points(state, merge_eps_3d, merge_px)
                profiling.count("finalize.merged", n)
                n_total += int(n)
                remap_total = remap if remap_total is None else remap[remap_total.long()]
            info["merged_points"] = n_total
            info["point_remap"] = remap_total
    for r in range(rounds):
        with profiling.span("finalize.cull"):
            state = cull_map(state, max_error_px=cull_px)
            state, stats = ba_mod.bundle_adjust_map(
                state, max_iterations=max_iterations, cg_iters=cg_iters)
            info[f"round{r}_cost"] = float(stats.final_cost)
    info["points"] = int(state.point_valid.sum())
    return state, info
