"""Distributed bundle adjustment: point-block-sharded Schur reduction.

PyTorch port of ``sfm_mvs_tpu/parallel/distributed_ba.py``. The map's
dense (P, C) observation grid and its point state are cut into contiguous
POINT BLOCKS, one per rank of the mesh; camera state is replicated. Each
rank eliminates its own point blocks locally (V, V^-1 and the point
back-substitution never leave it); only the small reduced camera system,
(C, 6, 6) Hessian blocks, (C, 6) gradients and the CG products, is
all-reduced (``models/ba.py`` with `group`). The camera trajectory
matches the single-process solve to rounding (the reductions sum the
blocks in another order), and every rank holds the same camera bits.

The functions take the whole problem or map on every rank, solve on this
rank's block, and all-gather the point blocks, so every rank returns the
whole result. There is no jit cache to keep (the JAX package's
``_sharded_runner``): PyTorch runs eagerly.
"""

from __future__ import annotations

import torch

from sfm_mvs_tpu_torch.models import ba
from sfm_mvs_tpu_torch.models.ba import BAProblem, BAStats
from sfm_mvs_tpu_torch.models.map_store import MapState
from sfm_mvs_tpu_torch.parallel.mesh import Mesh, all_gather, as_mesh, block

# The BAProblem fields cut into point blocks; the rest are replicated.
BA_BLOCKED = ("points", "point_valid", "obs_uv", "obs_mask")
BA_REPLICATED = ("cam_params", "cam_valid", "K", "frozen", "intr")


def shard_problem(prob: BAProblem, mesh: Mesh) -> BAProblem:
    """This rank's point block of a BAProblem (the JAX in_specs): points,
    point_valid, obs_uv and obs_mask blocked; camera state replicated."""
    sl = block(prob.points.shape[0], mesh)
    return prob._replace(**{f: getattr(prob, f)[sl] for f in BA_BLOCKED})


def run_ba_sharded(prob: BAProblem, mesh, max_iterations: int = 20, cg_iters: int = 20,
                   damping_init: float = 1e-3, huber_delta: float = 0.0
                   ) -> tuple[BAProblem, BAStats]:
    """LM bundle adjustment with the point axis blocked over the mesh's
    ranks (a ``Mesh`` or a process group). `prob` is the whole problem, the
    same on every rank; the point count must divide by the rank count.
    Returns the whole solved problem (point blocks all-gathered) and the
    stats, the same on every rank."""
    mesh = as_mesh(mesh)
    out, stats = ba.run_ba(shard_problem(prob, mesh), max_iterations=max_iterations,
                           cg_iters=cg_iters, damping_init=damping_init,
                           huber_delta=huber_delta, group=mesh)
    whole = {f: getattr(prob, f) for f in BA_BLOCKED}
    whole["points"] = all_gather(out.points, mesh).reshape(prob.points.shape)
    return out._replace(**whole), stats


def bundle_adjust_window_sharded(state: MapState, mesh, window_cams: int = 16,
                                 window_points: int = 16384, max_iterations: int = 8,
                                 cg_iters: int = 12, freeze_cams: int = 2,
                                 huber_delta: float = 0.0) -> tuple[MapState, BAStats]:
    """Sliding-window local BA with the WINDOW's point axis blocked over the
    mesh: the distributed ``ba.bundle_adjust_window``. The (Wp, Wc)
    sub-problem is cut as the single-process version cuts it, then its Wp
    points are blocked over the ranks (Wp must divide by the rank count)
    and solved by ``run_ba_sharded``. Returns (MapState, BAStats), the same
    on every rank."""
    prob, cut = ba._window_problem(state, window_cams, window_points, freeze_cams)
    prob, stats = run_ba_sharded(prob, mesh, max_iterations=max_iterations,
                                 cg_iters=cg_iters, huber_delta=huber_delta)
    return ba._window_write_back(state, prob, cut), stats


def prob_intr(dtype=torch.float32, device=None) -> torch.Tensor:
    """The identity shared intrinsics [1, 0, 0] of a 6-dof problem (the
    window problem's `intr`)."""
    return torch.tensor(ba._INTR_IDENTITY, dtype=dtype, device=device)


def bundle_adjust_map_sharded(state: MapState, mesh, max_iterations: int = 20,
                              cg_iters: int = 20, frozen_first: int = 1,
                              huber_delta: float = 0.0) -> tuple[MapState, BAStats]:
    """map -> distributed BA -> map, the same map on every rank."""
    prob = ba.problem_from_map(state, frozen_first=frozen_first)
    prob, stats = run_ba_sharded(prob, mesh, max_iterations=max_iterations,
                                 cg_iters=cg_iters, huber_delta=huber_delta)
    return ba.write_back_to_map(state, prob), stats
