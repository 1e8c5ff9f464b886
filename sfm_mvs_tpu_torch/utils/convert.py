"""State carried across between the JAX package and the port.

Turns the JAX package's ``Features``, ``Matches``, ``MapState`` and
``PipelineState`` (given with numpy leaves, ``np.asarray`` of each) into
the port's tensors, and the port's back into numpy, so that both packages
can start a step from the same state. The NamedTuples of the two packages
have the same names and fields; dtypes are kept (int32 stays int32).
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_mvs_tpu_torch.models.incremental import PipelineState
from sfm_mvs_tpu_torch.models.map_store import MapState
from sfm_mvs_tpu_torch.ops.matching import Matches
from sfm_mvs_tpu_torch.ops.sift import Features

_PORT_TYPES = {c.__name__: c for c in (Features, Matches, MapState, PipelineState)}


def to_torch(state, device=None):
    """NamedTuple with array leaves -> the port's NamedTuple of tensors."""
    name = type(state).__name__
    cls = _PORT_TYPES.get(name)
    if cls is None or cls._fields != type(state)._fields:
        raise TypeError(f"no port counterpart with the same fields for {name}")
    return cls(*[
        to_torch(v, device) if isinstance(v, tuple)
        else torch.as_tensor(np.array(v), device=device)
        for v in state
    ])


def to_numpy(state):
    """The port's NamedTuple of tensors -> the same NamedTuple of numpy arrays."""
    return type(state)(*[
        to_numpy(v) if isinstance(v, tuple) else v.detach().cpu().numpy()
        for v in state
    ])
