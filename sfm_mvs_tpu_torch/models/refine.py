"""Map refinement: outlier culling + final global bundle adjustment.

PyTorch port of ``sfm_mvs_tpu/models/refine.py``: drop observations whose
reprojection error exceeds a threshold, drop points left with fewer than
two observations, then run a global BA; all masked grid math.
"""

from __future__ import annotations

import torch

from sfm_mvs_tpu_torch.models import ba as ba_mod
from sfm_mvs_tpu_torch.models.map_store import MapState


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
    trajectory straight instead of being culled. Returns (MapState, info).
    Duplicate-landmark merging (``merge_eps_3d > 0``) comes with loop
    closure and is not ported yet.
    """
    if merge_eps_3d > 0.0:
        raise NotImplementedError(
            "merging duplicate landmarks (merge_eps_3d > 0, loop closure) is not "
            "ported yet (ROADMAP A12)")
    info = {}
    if robust_iterations > 0:
        state, stats = ba_mod.bundle_adjust_map(
            state, max_iterations=robust_iterations, cg_iters=cg_iters,
            huber_delta=robust_huber_px)
        info["robust_cost"] = float(stats.final_cost)
    for r in range(rounds):
        state = cull_map(state, max_error_px=cull_px)
        state, stats = ba_mod.bundle_adjust_map(
            state, max_iterations=max_iterations, cg_iters=cg_iters)
        info[f"round{r}_cost"] = float(stats.final_cost)
    info["points"] = int(state.point_valid.sum())
    return state, info
