"""Map-state checkpoint / resume.

PyTorch port of ``sfm_mvs_tpu/utils/checkpoint.py``, in the same file
format: the full pipeline state (map + the newest frame's features + its
track ids) serializes to one compressed ``.npz`` with the keys ``map_*``,
``feat_*``, ``prev_track`` and ``frame_index``, each array in the dtype
the JAX package writes (float32, int32, bool). A checkpoint written by
either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from sfm_mvs_tpu_torch.models.incremental import PipelineState
from sfm_mvs_tpu_torch.models.map_store import MapState
from sfm_mvs_tpu_torch.ops.sift import Features
from sfm_mvs_tpu_torch.utils.device import resolve_device


def _arrays(prefix: str, nt) -> dict:
    return {f"{prefix}{k}": v.detach().cpu().numpy() for k, v in nt._asdict().items()}


def _tensors(z, prefix: str, cls, device):
    return cls(**{k: torch.as_tensor(z[f"{prefix}{k}"], device=device) for k in cls._fields})


def save_map(path: str, state: MapState) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **_arrays("map_", state))


def load_map(path: str, device="cuda") -> MapState:
    """The map of a checkpoint on `device` (without a GPU pass device="cpu")."""
    return _tensors(np.load(path), "map_", MapState, resolve_device(device))


def save_pipeline(path: str, pstate: PipelineState, frame_index: int) -> None:
    """Checkpoint the full incremental state after `frame_index`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = _arrays("map_", pstate.map)
    payload.update(_arrays("feat_", pstate.prev_feats))
    payload["prev_track"] = pstate.prev_track.detach().cpu().numpy()
    payload["frame_index"] = np.asarray(frame_index)
    np.savez_compressed(path, **payload)


def load_pipeline(path: str, device="cuda") -> tuple[PipelineState, int]:
    """(PipelineState on `device`, frame index) from a checkpoint (without a
    GPU pass device="cpu")."""
    device = resolve_device(device)
    z = np.load(path)
    return (
        PipelineState(map=_tensors(z, "map_", MapState, device),
                      prev_feats=_tensors(z, "feat_", Features, device),
                      prev_track=torch.as_tensor(z["prev_track"], device=device)),
        int(z["frame_index"]),
    )


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    cands = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("frame_") and f.endswith(".npz"))
    return os.path.join(ckpt_dir, cands[-1]) if cands else None
