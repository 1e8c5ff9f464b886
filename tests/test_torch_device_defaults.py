"""The port's Python API runs on the card unless the caller asks for the CPU.

``IncrementalSfM``, ``GlobalSfM``, ``build_view_graph`` (when it detects
features itself), ``redetect_for_sweep`` (for numpy frames without K),
``map_store.init_map`` (for a K that is not a tensor) and the checkpoint
loaders default to ``device="cuda"``. Where CUDA is absent they raise a
RuntimeError that names ``device="cpu"``; nothing falls back to the CPU
silently. ``init_map`` keeps every field on a tensor K's device. Each test decides at run time whether the
machine has a GPU (and skips there: the defaults then just work).
"""

import numpy as np
import pytest
import torch

from sfm_mvs_tpu_torch.models import densify, exhaustive, map_store
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
                                                                      max_points=8),
                               device="cpu")
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


def test_global_sfm_defaults_to_cuda():
    from sfm_mvs_tpu_torch.models.tracks import GlobalSfM

    _skip_with_cuda()
    with pytest.raises(RuntimeError, match=NAMES_CPU):
        GlobalSfM(SfmConfig())
    assert GlobalSfM(SfmConfig(), device="cpu").device == torch.device("cpu")


def test_redetect_for_sweep_defaults_to_cuda():
    _skip_with_cuda()
    cfg = SfmConfig()
    g = np.random.default_rng(0).random((48, 64)).astype(np.float32)
    with pytest.raises(RuntimeError, match=NAMES_CPU):
        densify.redetect_for_sweep([g], cfg)
    f, = densify.redetect_for_sweep([g], cfg, device="cpu")
    assert f.xy.device.type == "cpu"
    # A tensor frame is detected where it lies; numpy frames follow K.
    f, = densify.redetect_for_sweep([torch.as_tensor(g)], cfg)
    assert f.xy.device.type == "cpu"
    f, = densify.redetect_for_sweep([g], cfg, K=torch.eye(3))
    assert f.desc.device.type == "cpu"


def test_init_map_follows_k_or_defaults_to_cuda():
    cfg = MapConfig(max_cameras=4, max_points=8)
    state = map_store.init_map(torch.eye(3), cfg)
    assert {t.device.type for t in state} == {"cpu"}
    state = map_store.init_map(torch.eye(3), cfg, device="cpu")
    assert {t.device.type for t in state} == {"cpu"}
    _skip_with_cuda()
    with pytest.raises(RuntimeError, match=NAMES_CPU):
        map_store.init_map(np.eye(3, dtype=np.float32), cfg)
