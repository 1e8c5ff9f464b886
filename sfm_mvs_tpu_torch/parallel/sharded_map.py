"""Sharded map-store queries: 2D-3D correspondence lookup outside BA.

PyTorch port of ``sfm_mvs_tpu/parallel/sharded_map.py``: queries against a
point table cut into contiguous blocks, one per rank
(``mesh.shard_map_state``), each answered with small collectives.

- :func:`lookup_points_sharded`: 3D points (+ validity) for a batch of
  track ids. Each rank resolves the ids inside its block (contiguous blocks
  = one range test, no routing tables) and contributes zeros elsewhere; one
  all-reduce of X and one of the ok count assemble the answer, exactly
  (only one rank adds a nonzero). The sharded form of ``state.points[tids]``.
- :func:`nearest_projected_sharded`: for query pixels, the nearest
  *projected* valid map point (squared pixel distance + its depth). Each
  rank scans only its block's (M, B) distances, then an all-gather of the
  per-block minima (S x M scalars) finishes the argmin, ties going to the
  lowest rank as ``jnp.argmin`` gives them.

The distances' cross term has an inner dimension of 2, so it is two
float32 broadcast products (the JAX package computes it outside any Pallas
kernel too) rather than a GEMM, whose rounding could depend on the block's
width: the expansion cancels ~|uv|^2 ~ 1e6 px^2 down to a few px^2, so one
rounding step shows. Each distance then carries the same bits as the
single-process form (:func:`squared_distances`) on every block layout.
"""

from __future__ import annotations

import torch

from sfm_mvs_tpu_torch.ops import projection
from sfm_mvs_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce, as_mesh


def lookup_points_sharded(points: torch.Tensor, point_valid: torch.Tensor,
                          tids: torch.Tensor, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Sharded gather: points[tids] with the point table blocked over ranks.

    points: (B, 3), this rank's block (rows [r B, (r + 1) B) of the table);
    point_valid: (B,); tids: (M,) track ids, -1 or out of range -> invalid.
    Returns (X (M, 3), ok (M,)), the same on every rank.
    """
    mesh = as_mesh(mesh)
    blk = points.shape[0]
    ids = tids.to(torch.int64)
    lo = mesh.rank * blk
    local = ids - lo
    mine = (ids >= lo) & (local < blk) & (ids >= 0)
    safe = torch.clamp(local, 0, blk - 1)
    X = torch.where(mine[:, None], points[safe], torch.zeros((), dtype=points.dtype,
                                                             device=points.device))
    ok = mine & point_valid[safe]
    return all_reduce(X, mesh), all_reduce(ok.to(torch.int32), mesh) > 0


def squared_distances(uv_q: torch.Tensor, uv_map: torch.Tensor) -> torch.Tensor:
    """(M, B) squared pixel distances |q|^2 + |m|^2 - 2 q.m of queries
    uv_q (M, 2) to points uv_map (B, 2), per element in one fixed order."""
    cross = uv_q[:, 0, None] * uv_map[None, :, 0] + uv_q[:, 1, None] * uv_map[None, :, 1]
    return (uv_q * uv_q).sum(1)[:, None] + (uv_map * uv_map).sum(1)[None, :] - 2.0 * cross


def nearest_projected_sharded(points: torch.Tensor, point_valid: torch.Tensor,
                              pose: torch.Tensor, K: torch.Tensor, uv_query: torch.Tensor,
                              mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest projected map point per query pixel, point table blocked.

    points (B, 3) / point_valid (B,): this rank's block. Each rank projects
    its block into the camera `pose` (3, 4) and finds the block-local
    (min squared pixel distance, depth at the argmin) for every query with
    (M, B) distances (:func:`squared_distances`); an all-gather of the S
    per-block minima completes the global argmin. Returns (min_d2 (M,), depth (M,)), the
    same on every rank; a block with no valid point contributes inf.
    """
    mesh: Mesh = as_mesh(mesh)
    uv_map, depth = projection.project_depth(points, pose, K)
    ok = point_valid & (depth > 0)
    d2 = squared_distances(uv_query, uv_map)
    d2 = torch.where(ok[None, :], d2, torch.full_like(d2, float("inf")))
    dmin, j = d2.min(dim=1)
    zmin = depth[j]
    dall = all_gather(dmin, mesh)  # (S, M)
    zall = all_gather(zmin, mesh)
    best = torch.argmin(dall, dim=0)  # the lowest rank on ties
    m = torch.arange(dall.shape[1], device=dall.device)
    return dall[best, m], zall[best, m]
