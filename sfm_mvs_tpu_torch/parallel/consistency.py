"""Replicated-state consistency checks (the domain's race detector).

PyTorch port of ``sfm_mvs_tpu/parallel/consistency.py``. In a sharded run
the invariant that can break is replication: camera state must be the
same on every rank after a distributed-BA step (every reduction is
all-reduced before use). These helpers checksum each rank's replica,
gather the checksums, and assert that they agree.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.distributed as dist

from sfm_mvs_tpu_torch.parallel.mesh import Mesh, all_gather


def _checksum(x: torch.Tensor) -> float:
    arr = x.detach().cpu().numpy().astype(np.float64)
    return float(arr.sum()) + 1e-9 * float(np.abs(arr).sum())


def device_checksums(x: torch.Tensor, mesh: Mesh) -> list[float]:
    """Every rank's float64 checksum of its replica of `x`, in rank order."""
    s = torch.tensor([_checksum(x)], dtype=torch.float64, device=x.device)
    return [float(v) for v in all_gather(s, mesh).reshape(-1).cpu()]


def assert_replicated(x: torch.Tensor, mesh: Mesh, name: str = "array",
                      atol: float = 0.0) -> None:
    """Raise if the ranks' replicas of `x` disagree.

    atol = 0 demands bitwise-identical replicas: besides the checksums,
    every rank's ``state_fingerprint`` must match rank 0's (all-reduced
    quantities are computed identically on every rank). Every rank raises
    on a divergence.
    """
    sums = device_checksums(x, mesh)
    ref = sums[0]
    for i, s in enumerate(sums[1:], 1):
        if abs(s - ref) > atol:
            raise AssertionError(f"replication divergence in {name}: rank0={ref!r} "
                                 f"rank{i}={s!r}")
    if atol == 0.0:
        prints = [None] * mesh.size
        dist.all_gather_object(prints, state_fingerprint(x), group=mesh.group)
        for i, f in enumerate(prints[1:], 1):
            if f != prints[0]:
                raise AssertionError(f"replication divergence in {name}: rank0 bytes "
                                     f"{prints[0]} rank{i} bytes {f}")


def _leaves(tree):
    """Leaves in ``jax.tree_util.tree_leaves`` order: dict keys sorted,
    tuples (NamedTuples too) and lists in order, None no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def state_fingerprint(tree) -> str:
    """Deterministic hex fingerprint of a tree of tensors: sha256 over the
    leaves' bytes (C order), the JAX package's hex for equal arrays. Ranks or
    hosts compare fingerprints to detect divergence of state that should
    be identical."""
    h = hashlib.sha256()
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    return h.hexdigest()[:16]


def check_ba_replication(cam_params: torch.Tensor, points: torch.Tensor, mesh: Mesh) -> None:
    """Post-distributed-BA invariant: camera state replicated exactly."""
    assert_replicated(cam_params, mesh, "cam_params")
