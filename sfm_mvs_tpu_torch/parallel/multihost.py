"""Multi-host runtime: process-group initialization and a 2-D rank layout.

PyTorch port of ``sfm_mvs_tpu/parallel/multihost.py``. ``initialize``
starts ``torch.distributed`` from torch's own environment variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as a launcher
such as ``torchrun`` sets them) and is a no-op on a single process.
``slice_mesh`` lays the ranks out as (hosts, ranks_per_host) with one
sub-group per row and per column, the counterpart of the JAX (DCN, ICI)
mesh: the front end shards frames over all ranks, distributed BA blocks
its points over a host's ranks (``ici``, whose per-CG-step collectives then
stay on the host's links) and replicates over hosts (``dcn``).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from sfm_mvs_tpu_torch.parallel.distributed_ba import BA_BLOCKED, BA_REPLICATED
from sfm_mvs_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: str = "nccl") -> bool:
    """Initialize ``torch.distributed`` from the arguments or the standard
    env vars. Returns True when a multi-process group was initialized; safe
    to call in a single process (returns False, does nothing).

    init_method defaults to ``tcp://$MASTER_ADDR:$MASTER_PORT``. backend:
    "nccl" for one card per rank (each rank then takes card
    ``$LOCAL_RANK``, else rank mod the card count), "gloo" for CPU ranks or
    ranks sharing a card.
    """
    if init_method is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if not init_method or world_size in (None, 1):
        return False
    if rank is None:
        raise ValueError(f"a world of {world_size} ranks needs this rank: set RANK or pass rank=")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return True


class SliceMesh(NamedTuple):
    """(hosts, ranks_per_host) layout: `ici` is this rank's host (its row),
    `dcn` the ranks of its local index on every host (its column)."""

    hosts: int
    ranks_per_host: int
    ici: Mesh
    dcn: Mesh


def slice_mesh(ranks_per_host: Optional[int] = None) -> SliceMesh:
    """Sub-groups of the initialized world for a (hosts, ranks_per_host)
    layout; ranks_per_host defaults to ``$LOCAL_WORLD_SIZE``, else the world
    (one host). Every rank must call it (``dist.new_group`` is collective)."""
    world, me = dist.get_world_size(), dist.get_rank()
    per = ranks_per_host or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per:
        raise ValueError(f"world of {world} ranks does not split into hosts of {per}")
    hosts = world // per
    ici = dcn = None
    for h in range(hosts):
        g = dist.new_group(list(range(h * per, (h + 1) * per)))
        if me // per == h:
            ici = g
    for local in range(per):
        g = dist.new_group([h * per + local for h in range(hosts)])
        if me % per == local:
            dcn = g
    return SliceMesh(hosts, per, make_mesh(ici), make_mesh(dcn))


def ba_shardings(mesh: SliceMesh) -> dict:
    """Placements for distributed BA on a slice: the point-axis arrays of a
    BAProblem are blocked over the host's ranks (``mesh.ici``, the group to
    hand to ``distributed_ba``) and replicated over hosts; camera state is
    replicated everywhere."""
    return {"points": (BA_BLOCKED, mesh.ici), "cameras": (BA_REPLICATED, None)}
