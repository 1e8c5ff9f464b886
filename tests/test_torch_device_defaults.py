"""The port's Python API runs on the card unless the caller asks for the CPU.

``IncrementalSfM``, ``build_view_graph`` (when it detects features itself)
and the checkpoint loaders default to ``device="cuda"``. Where CUDA is
absent they raise a RuntimeError that names ``device="cpu"``; nothing falls
back to the CPU silently. Each test decides at run time whether the
machine has a GPU (and skips there: the defaults then just work).
"""

import numpy as np
import pytest
import torch

from sfm_mvs_tpu_torch.models import exhaustive, map_store
from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM, PipelineState, resolve_device
from sfm_mvs_tpu_torch.ops.sift import Features
from sfm_mvs_tpu_torch.utils import checkpoint
from sfm_mvs_tpu_torch.utils.config import MapConfig, SfmConfig

NAMES_CPU = 'device="cpu"'


def _skip_with_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the cuda default runs here")


def _tiny_checkpoint(path):
    state = map_store.init_map(np.eye(3, dtype=np.float32), MapConfig(max_cameras=4,
                                                                      max_points=8))
    n = 16
    feats = Features(xy=torch.zeros((n, 2)), scale=torch.ones(n), angle=torch.zeros(n),
                     response=torch.zeros(n), desc=torch.zeros((n, 128)),
                     valid=torch.zeros(n, dtype=torch.bool))
    ps = PipelineState(map=state, prev_feats=feats,
                       prev_track=torch.full((n,), -1, dtype=torch.int32))
    checkpoint.save_pipeline(str(path), ps, 3)
    return ps


def test_incremental_sfm_defaults_to_cuda():
    _skip_with_cuda()
    with pytest.raises(RuntimeError, match=NAMES_CPU):
        IncrementalSfM(SfmConfig())
    with pytest.raises(RuntimeError, match=NAMES_CPU):
        IncrementalSfM(SfmConfig(), device="cuda:0")
    assert IncrementalSfM(SfmConfig(), device="cpu").device == torch.device("cpu")


def test_build_view_graph_defaults_to_cuda():
    _skip_with_cuda()
    imgs = [np.zeros((48, 64), np.float32)] * 2
    with pytest.raises(RuntimeError, match=NAMES_CPU):
        exhaustive.build_view_graph(imgs)


def test_checkpoint_loaders_default_to_cuda(tmp_path):
    _skip_with_cuda()
    path = tmp_path / "frame_00003.npz"
    ps = _tiny_checkpoint(path)
    with pytest.raises(RuntimeError, match=NAMES_CPU):
        checkpoint.load_pipeline(str(path))
    with pytest.raises(RuntimeError, match=NAMES_CPU):
        checkpoint.load_map(str(path))
    loaded, frame = checkpoint.load_pipeline(str(path), device="cpu")
    assert frame == 3 and torch.equal(loaded.prev_track, ps.prev_track)
    assert checkpoint.load_map(str(path), device="cpu").points.device.type == "cpu"


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_resolve_device_keeps_the_cpu(device):
    assert resolve_device(device) == torch.device("cpu")
