"""Fixed-capacity structure-of-arrays map: cameras, points, observations.

PyTorch port of ``sfm_mvs_tpu/models/map_store.py`` (the parts the
incremental path runs). Every table has a static capacity and a validity
mask; observations are a dense (max_points, max_cameras) grid. Appends are
masked writes: rows that the JAX package routes out of range (and
``mode="drop"`` discards) are filtered out before the write, since torch
raises on out-of-range indices. The functions return new states and do not
modify their inputs (the driver relies on that to reject a frame).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_mvs_tpu_torch.utils.config import MapConfig


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
    """Empty map with the configured capacities, on `device`."""
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
    """Copy of `dst` with dst[index[i]] = values[i] for rows where `keep`.

    The kept indices must be distinct and in range (the callers' invariant).
    """
    out = dst.clone()
    out[index[keep].long()] = values[keep].to(dst.dtype)
    return out


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
    keep = dest < capacity
    return (
        state._replace(
            points=_set_rows(state.points, dest, X, keep),
            colors=_set_rows(state.colors, dest, colors, keep),
            point_valid=_set_rows(state.point_valid, dest, valid, keep),
            num_points=new_count,
        ),
        torch.where(valid, dest, torch.full_like(dest, -1)),
    )


def append_observations(state: MapState, cam_id, point_ids, uv, valid) -> MapState:
    """Record observations of `point_ids` in camera `cam_id` (scalar).

    Duplicate valid point ids (two feature slots claiming one track) are
    resolved deterministically, as in the JAX package: the lowest slot wins
    (a scatter-min of the slot index, then a gather).
    """
    M = point_ids.shape[0]
    P = state.points.shape[0]
    dev = point_ids.device
    # Ids past the capacity (append_points returns them for rows that
    # overflowed it) are never written, as in the JAX package.
    dest = torch.where(valid & (point_ids >= 0) & (point_ids < P), point_ids,
                       torch.full_like(point_ids, P)).long()
    slot = torch.arange(M, device=dev)
    winner = torch.full((P + 1,), M, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(0, dest, slot, reduce="amin")
    cam = torch.as_tensor(cam_id, device=dev).long()
    keep = (dest < P) & (winner[dest] == slot) & (cam < state.obs_mask.shape[1])
    rows = dest[keep]
    obs_uv = state.obs_uv.clone()
    obs_mask = state.obs_mask.clone()
    obs_uv[rows, cam] = uv[keep].to(obs_uv.dtype)
    obs_mask[rows, cam] = True
    return state._replace(obs_uv=obs_uv, obs_mask=obs_mask)
