"""Rank meshes, the collectives of the sharded paths, and block layouts.

PyTorch port of ``sfm_mvs_tpu/parallel/mesh.py``. A JAX ``Mesh`` axis is a
set of devices that ``shard_map`` splits arrays over; here a :class:`Mesh`
is one initialized process group, each rank standing for one device of the
axis. ``shard_batch`` and ``shard_map_state`` give this rank's block of a
batch or of the map's point axis (what the JAX ``NamedSharding``s place on
each device), ``replicated`` is the identity, and :func:`all_reduce` /
:func:`all_gather` are the ``psum`` / ``all_gather`` of the sharded code.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """One axis of ranks: a process group (None: the default group), this
    rank's index in it, its size and its backend."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    backend: str


def make_mesh(group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The mesh of an initialized process group (default: the whole world).

    The group comes from ``dist.init_process_group`` (or
    ``multihost.initialize``) and ``dist.new_group``; its backend is the
    caller's choice, made there.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: call "
                           "dist.init_process_group(...) or multihost.initialize(...)")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                str(dist.get_backend(group)))


def as_mesh(mesh) -> Mesh:
    """A Mesh as it is; a ProcessGroup (or None, the default group) wrapped."""
    return mesh if isinstance(mesh, Mesh) else make_mesh(mesh)


def all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of `x` over the mesh's ranks (``psum``); a new tensor, every rank
    gets the same bits."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=mesh.group)
    return y


def all_reduce_many(xs: Sequence[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """``all_reduce`` of each tensor of one dtype, in one collective over
    their concatenation (the same elementwise sums)."""
    flat = torch.cat([x.reshape(-1) for x in xs])
    dist.all_reduce(flat, group=mesh.group)
    out, o = [], 0
    for x in xs:
        out.append(flat[o:o + x.numel()].view(x.shape))
        o += x.numel()
    return out


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(mesh.size, *x.shape): every rank's `x`, in rank order (bool tensors
    travel as uint8)."""
    send = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    out = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(out, send, group=mesh.group)
    out = torch.stack(out)
    return out.bool() if x.dtype == torch.bool else out


def block(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous block of an axis of length n (n must divide
    by the mesh size, as a JAX sharding requires)."""
    if n % mesh.size:
        raise ValueError(f"axis of length {n} does not divide over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a leading data-parallel batch axis."""
    return x[block(x.shape[0], mesh)]


def replicated(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated array: every rank holds all of it."""
    return x


MAP_POINT_FIELDS = ("points", "colors", "point_valid", "obs_uv", "obs_mask")


def shard_map_state(state, mesh: Mesh):
    """This rank's POINT block of a MapState: points, colors, point_valid
    and the (P, C) observation grid, rows [r P / W, (r + 1) P / W). Camera
    state and counters stay replicated; ``num_points`` stays the global
    count. The layout the sharded map queries (``sharded_map``) take."""
    sl = block(state.points.shape[0], mesh)
    return state._replace(**{f: getattr(state, f)[sl] for f in MAP_POINT_FIELDS})
