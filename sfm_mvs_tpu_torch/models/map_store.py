"""Fixed-capacity structure-of-arrays map: cameras, points, observations.

PyTorch port of ``sfm_mvs_tpu/models/map_store.py`` (the parts the
incremental path and finalize run). Every table has a static capacity and
a validity mask; observations are a dense (max_points, max_cameras) grid.
Appends are masked writes: rows that the JAX package routes out of range
(and ``mode="drop"`` discards) are kept out of the write, since torch
raises on out-of-range indices. The functions return new states and do not
modify their inputs (the driver relies on that to reject a frame).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_mvs_tpu_torch.utils.config import MapConfig
from sfm_mvs_tpu_torch.utils.device import resolve_device


class MapState(NamedTuple):
    """The reconstruction: flat arrays + counters."""

    K: torch.Tensor  # (3, 3) shared intrinsics
    poses: torch.Tensor  # (max_cams, 3, 4) world->cam [R|t]
    cam_valid: torch.Tensor  # (max_cams,) bool
    num_cams: torch.Tensor  # () int32
    points: torch.Tensor  # (max_pts, 3)
    colors: torch.Tensor  # (max_pts, 3) BGR in [0, 255]
    point_valid: torch.Tensor  # (max_pts,) bool
    num_points: torch.Tensor  # () int32
    obs_uv: torch.Tensor  # (max_pts, max_cams, 2) pixel observations
    obs_mask: torch.Tensor  # (max_pts, max_cams) bool


def init_map(K, cfg: MapConfig, device=None) -> MapState:
    """Empty map with the configured capacities, every field on one device:
    `device` if given, else K's when K is a tensor, else ``cuda`` (which
    raises without CUDA; pass ``device="cpu"`` there)."""
    if device is None:
        if isinstance(K, torch.Tensor):
            device = K.device
        else:
            device = resolve_device("cuda")
    P, C = cfg.max_points, cfg.max_cameras
    f32 = dict(dtype=torch.float32, device=device)
    return MapState(
        K=torch.as_tensor(K, **f32),
        poses=torch.zeros((C, 3, 4), **f32),
        cam_valid=torch.zeros((C,), dtype=torch.bool, device=device),
        num_cams=torch.zeros((), dtype=torch.int32, device=device),
        points=torch.zeros((P, 3), **f32),
        colors=torch.zeros((P, 3), **f32),
        point_valid=torch.zeros((P,), dtype=torch.bool, device=device),
        num_points=torch.zeros((), dtype=torch.int32, device=device),
        obs_uv=torch.zeros((P, C, 2), **f32),
        obs_mask=torch.zeros((P, C), dtype=torch.bool, device=device),
    )


def num_observations(state: MapState) -> torch.Tensor:
    return state.obs_mask.sum(dtype=torch.int32)


def _set_rows(dst: torch.Tensor, index: torch.Tensor, values: torch.Tensor,
              keep: torch.Tensor) -> torch.Tensor:
    """Copy of `dst` with dst[index[i]] = values[i] for rows where `keep`
    and 0 <= index[i] < len(dst).

    The other rows are written to a spare row that is then cut off, so no
    host sync filters them. The kept indices must be distinct.
    """
    n = dst.shape[0]
    dest = torch.where(keep & (index >= 0) & (index < n), index, torch.full_like(index, n))
    out = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    return out.index_copy_(0, dest.long(), values.to(dst.dtype))[:-1]


def append_camera(state: MapState, pose: torch.Tensor):
    """Add one camera; returns (state, cam_id)."""
    cam_id = state.num_cams
    slot = torch.arange(state.poses.shape[0], device=pose.device) == cam_id
    return (
        state._replace(
            poses=torch.where(slot[:, None, None], pose, state.poses),
            cam_valid=state.cam_valid | slot,
            num_cams=state.num_cams + 1,
        ),
        cam_id,
    )


def _append_indices(count: torch.Tensor, valid: torch.Tensor, capacity: int):
    """Scatter destinations for a masked append.

    Row i goes to `count + (#valid rows before i)`; invalid rows get
    `capacity` (out of range: dropped). Returns (dest (N,) int32,
    new_count clamped to capacity).
    """
    v = valid.to(torch.int32)
    dest = count + torch.cumsum(v, 0, dtype=torch.int32) - 1
    dest = torch.where(valid, dest, torch.full_like(dest, capacity))
    new_count = count + v.sum(dtype=torch.int32)
    return dest, torch.clamp_max(new_count, capacity)


def append_points(state: MapState, X, colors, valid):
    """Masked-append new 3D points. Returns (state, point_ids (N,) int32),
    point_ids[i] = the map index of row i, or -1 where ~valid."""
    capacity = state.points.shape[0]
    dest, new_count = _append_indices(state.num_points, valid, capacity)
    return (
        state._replace(
            points=_set_rows(state.points, dest, X, valid),
            colors=_set_rows(state.colors, dest, colors, valid),
            point_valid=_set_rows(state.point_valid, dest, valid, valid),
            num_points=new_count,
        ),
        torch.where(valid, dest, torch.full_like(dest, -1)),
    )


def append_observations(state: MapState, cam_id, point_ids, uv, valid) -> MapState:
    """Record observations of `point_ids` in camera `cam_id` (scalar).

    Duplicate valid point ids (two feature slots claiming one track) are
    resolved deterministically, as in the JAX package: the lowest slot wins
    (a scatter-min of the slot index, then a gather). The write goes to the
    flattened (P * C) grid through ``_set_rows``, so no host sync filters
    the rejected rows.
    """
    M = point_ids.shape[0]
    P, C = state.obs_mask.shape
    dev = point_ids.device
    # Ids past the capacity (append_points returns them for rows that
    # overflowed it) are never written, as in the JAX package.
    dest = torch.where(valid & (point_ids >= 0) & (point_ids < P), point_ids,
                       torch.full_like(point_ids, P)).long()
    slot = torch.arange(M, device=dev)
    winner = torch.full((P + 1,), M, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(0, dest, slot, reduce="amin")
    cam = torch.as_tensor(cam_id, device=dev).long()
    keep = (dest < P) & (winner[dest] == slot) & (cam < C)
    flat = dest * C + cam
    obs_uv = _set_rows(state.obs_uv.reshape(P * C, 2), flat, uv, keep)
    obs_mask = _set_rows(state.obs_mask.reshape(P * C), flat, keep, keep)
    return state._replace(obs_uv=obs_uv.reshape(P, C, 2), obs_mask=obs_mask.reshape(P, C))


def compact_points(state: MapState):
    """Move valid points to the front of the point axis. Returns
    (state, remap) where remap[i] is point i's new index (-1 for dropped
    slots): callers holding track ids must remap them.

    BA cost on the dense (P, C) grid is capacity-proportional, so compacting
    (then ``shrink_map``) right-sizes the grid before the global solves."""
    valid = state.point_valid
    offs = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1

    def compact(x):
        return _set_rows(torch.zeros_like(x), offs, x, valid)

    return (
        state._replace(
            points=compact(state.points), colors=compact(state.colors),
            point_valid=compact(valid), obs_uv=compact(state.obs_uv),
            obs_mask=compact(state.obs_mask), num_points=valid.sum(dtype=torch.int32),
        ),
        torch.where(valid, offs, torch.full_like(offs, -1)),
    )


def shrink_map(state: MapState, new_max_points: int) -> MapState:
    """Slice the point axis down to `new_max_points` (after compact_points;
    every live point must fit)."""
    if new_max_points >= state.points.shape[0]:
        return state
    if int(state.num_points) > new_max_points:
        raise ValueError(f"{int(state.num_points)} live points do not fit in "
                         f"{new_max_points}")
    return state._replace(
        points=state.points[:new_max_points],
        colors=state.colors[:new_max_points],
        point_valid=state.point_valid[:new_max_points],
        obs_uv=state.obs_uv[:new_max_points],
        obs_mask=state.obs_mask[:new_max_points],
    )


def reorder_cameras(state: MapState, perm) -> MapState:
    """Permute camera slots: new slot k holds old camera perm[k].

    The auto-bootstrap driver registers frames in view-graph order and
    then restores frame order. `perm` must be a permutation of
    range(num_cams); padded slots stay in place.
    """
    C = state.poses.shape[0]
    dev = state.poses.device
    perm = torch.as_tensor(perm, dtype=torch.int64, device=dev)
    full = torch.cat([perm, torch.arange(perm.shape[0], C, dtype=torch.int64, device=dev)])
    return state._replace(
        poses=state.poses[full],
        cam_valid=state.cam_valid[full],
        obs_uv=state.obs_uv[:, full],
        obs_mask=state.obs_mask[:, full],
    )


def grow_map(state: MapState, new_max_points: int) -> MapState:
    """A copy with the point capacity enlarged to `new_max_points` by zero
    padding; point indices (and track ids held outside) stay valid."""
    pad = new_max_points - state.points.shape[0]
    if pad <= 0:
        return state

    def grow(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    return state._replace(
        points=grow(state.points), colors=grow(state.colors),
        point_valid=grow(state.point_valid), obs_uv=grow(state.obs_uv),
        obs_mask=grow(state.obs_mask),
    )


def update_points(state: MapState, point_ids, X, valid) -> MapState:
    """Overwrite existing points (BA write-back)."""
    return state._replace(points=_set_rows(state.points, point_ids, X, valid))


def update_poses(state: MapState, cam_ids, poses, valid) -> MapState:
    """Overwrite existing camera poses (BA write-back)."""
    return state._replace(poses=_set_rows(state.poses, cam_ids, poses, valid))


def merge_duplicate_points(state: MapState, eps_3d, merge_px, block: int = 1024):
    """Merge map points that describe the same landmark twice.

    Loop closure can re-associate a landmark that already exists as two
    independent track chains; the duplicate then double-counts its
    evidence in BA. A pair (i, j < i) merges when (a) the 3D points lie
    within `eps_3d`, (b) every camera observing both sees them within
    `merge_px` pixels, (c) j is itself a merge root (no chains) and (d) i
    is j's closest candidate (one winner per target, lowest index on exact
    ties). Point i's observations fill the cameras where j has none; i is
    invalidated. One pass merges pairs; call again for larger clusters.

    The nearest lower-index neighbour is found in row blocks of `block`
    points against the whole map (distances from one float32 product per
    block). Returns (state, remap (P,) int64, remap[i] = the surviving id,
    identity for unmerged points, and n_merged, a 0-dim tensor).
    """
    P = state.points.shape[0]
    block = min(block, P)
    pts, pv = state.points, state.point_valid
    dev = pts.device
    eps2 = torch.as_tensor(eps_3d, dtype=pts.dtype, device=dev) ** 2
    idx_all = torch.arange(P, device=dev)
    sq = (pts * pts).sum(1)
    partner, pair_d2 = [], []
    for i0 in range(0, P, block):
        rows = pts[i0:i0 + block]
        ri = idx_all[i0:i0 + block]
        d2 = sq[i0:i0 + block, None] + sq[None, :] - (2.0 * rows) @ pts.T  # (block, P)
        ok = pv[i0:i0 + block, None] & pv[None, :] & (idx_all[None, :] < ri[:, None])
        d2 = torch.where(ok & (d2 < eps2), d2, torch.full_like(d2, float("inf")))
        dmin, j = d2.min(dim=1)  # the first index on ties, as jnp.argmin
        partner.append(torch.where(torch.isfinite(dmin), j, torch.full_like(j, -1)))
        pair_d2.append(dmin)
    partner = torch.cat(partner)
    pair_d2 = torch.cat(pair_d2)

    # (b) pixel-conflict test on the candidate pairs only: (P, C) work.
    safe_j = torch.clamp(partner, 0, P - 1)
    both = state.obs_mask & state.obs_mask[safe_j]
    duv = torch.linalg.norm(state.obs_uv - state.obs_uv[safe_j], dim=-1)
    conflict = (both & (duv > merge_px)).any(1)

    # (c) the target must be a root; (d) one winner per target. The
    # scatter-minimums write rejected rows to a spare slot P.
    cand = (partner >= 0) & (partner[safe_j] < 0) & ~conflict
    dest = torch.where(cand, partner, torch.full_like(partner, P))
    best_at_j = torch.full((P + 1,), float("inf"), dtype=pts.dtype, device=dev)
    best_at_j = best_at_j.scatter_reduce(0, dest, pair_d2, reduce="amin")
    winner = cand & (pair_d2 <= best_at_j[safe_j])
    dest = torch.where(winner, partner, torch.full_like(partner, P))
    first_at_j = torch.full((P + 1,), P, dtype=idx_all.dtype, device=dev)
    first_at_j = first_at_j.scatter_reduce(0, dest, idx_all, reduce="amin")
    winner = winner & (idx_all == first_at_j[safe_j])

    # Transfer observations i -> j where j lacks them; drop point i.
    add_mask = _set_rows(torch.zeros_like(state.obs_mask), partner,
                         state.obs_mask & winner[:, None], winner)
    add_uv = _set_rows(torch.zeros_like(state.obs_uv), partner, state.obs_uv, winner)
    new_mask = state.obs_mask | add_mask
    new_uv = torch.where(state.obs_mask[..., None], state.obs_uv, add_uv)
    cleared = winner[:, None]
    state = state._replace(
        point_valid=pv & ~winner,
        obs_mask=new_mask & ~cleared,
        obs_uv=torch.where(cleared[..., None], torch.zeros_like(new_uv), new_uv),
    )
    return state, torch.where(winner, partner, idx_all).to(torch.int32), winner.sum()
