"""The port's KLT-tracking pipeline (models/klt.py) against JAX.

Tolerances. ``replenish`` from one state in both packages (the port's
state after 4 frames, carried into the JAX package, and the port's
detection on the current frame): positions, alive and track ids bitwise.
One ``klt_step`` from that state with the JAX package's PnP samples
injected: the alive, inlier and observation masks and the track ids
identical, the new pose within 1e-4, the point counts equal (tracking
agrees to 1e-3 px, tests/test_torch_optical_flow.py). ``KltSfM`` on
tests/test_klt_pipeline.py's scene (6 frames at 320x240, redetect_every=3)
with that test's bounds: 6/6 cameras and more than 150 points, ATE < 0.06,
rotation error < 1.5 deg, every frame with more than 80 tracked features,
more than 30 PnP inliers and a reprojection error below 1 px, and
replenishment creating new points.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import J, N, T

from sfm_mvs_tpu.models import klt as jklt
from sfm_mvs_tpu.models import map_store as jms
from sfm_mvs_tpu.ops import optical_flow as jof
from sfm_mvs_tpu.ops import ransac as jransac
from sfm_mvs_tpu.ops import sift as jsift
from sfm_mvs_tpu.utils import config as jconfig
from sfm_mvs_tpu_torch.models import klt
from sfm_mvs_tpu_torch.ops import sift
from sfm_mvs_tpu_torch.utils import config, convert, evaluate
from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence


def _cfgs(K):
    def build(c):
        return c.SfmConfig(
            fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
            downscale=1,
            frontend=c.FrontendConfig(max_features=1024, num_octaves=3, upsample_input=True,
                                      contrast_threshold=0.015, lowe_ratio=0.75),
            map=c.MapConfig(max_cameras=8, max_points=16384))

    return build(config), build(jconfig)


@pytest.fixture(scope="module")
def scene():
    imgs, Rt, K = render_staircase_sequence(num_cameras=6, arc_degrees=20, image_size=(320, 240))
    cfg, jcfg = _cfgs(K)
    return imgs, Rt, cfg, jcfg


@pytest.fixture(scope="module")
def klt_run(scene):
    imgs, Rt, cfg, _ = scene
    k = klt.KltSfM(cfg, redetect_every=3, device="cpu")
    state = k.run(imgs)
    return k, state, Rt


@pytest.fixture(scope="module")
def mid_state(scene):
    """The port's KLT state after frames 0-3, and the same state in JAX."""
    imgs, _, cfg, _ = scene
    k = klt.KltSfM(cfg, redetect_every=3, device="cpu")
    k.run(imgs[:4])
    s = k.state
    js = jklt.KltState(map=jms.MapState(*[J(a) for a in convert.to_numpy(s.map)]),
                       prev_gray=J(s.prev_gray), positions=J(s.positions),
                       track_ids=J(s.track_ids), alive=J(s.alive))
    return s, js


def test_all_cameras_registered(klt_run):
    k, state, Rt = klt_run
    assert int(state.cam_valid.sum()) == 6
    assert int(state.num_points) > 150


def test_trajectory_accuracy(klt_run):
    k, state, Rt = klt_run
    poses = N(state.poses)[N(state.cam_valid)]
    assert evaluate.ate_rmse(poses, Rt) < 0.06
    assert evaluate.rotation_errors_deg(poses, Rt).max() < 1.5


def test_tracking_survives_frames(klt_run):
    k, state, Rt = klt_run
    assert [s["frame"] for s in k.stats] == [2, 3, 4, 5]
    for s in k.stats:
        assert s["tracked"] > 80
        assert s["pnp_inliers"] > 30
        assert s["reproj_error"] < 1.0
    assert any(s["new_points"] > 20 for s in k.stats[1:])
    assert k.state.track_ids.dtype == torch.int32 and k.state.alive.dtype == torch.bool


def test_replenish_matches_jax(scene, mid_state):
    imgs, _, cfg, jcfg = scene
    s, js = mid_state
    feats = sift.detect_and_compute(T(imgs[3]), cfg.frontend)
    jfeats = jsift.Features(*[J(a) for a in convert.to_numpy(feats)])
    ref = jklt.replenish(js, jfeats, jcfg)
    out = klt.replenish(s, feats, cfg)
    assert 0 < int((~s.alive).sum()) and int(out.alive.sum()) > int(s.alive.sum())
    for f in ("positions", "alive", "track_ids"):
        np.testing.assert_array_equal(N(getattr(out, f)), N(getattr(ref, f)), err_msg=f)
    assert out.map is s.map


def test_klt_step_matches_jax(scene, mid_state):
    imgs, _, cfg, jcfg = scene
    s, js = mid_state
    key = jax.random.PRNGKey(7)
    g = J(imgs[4])
    jout, jst = jklt.klt_step(key, js, g, jcfg)
    # The PnP draws JAX's klt_step makes inside ransac_pnp.
    flow = jof.track_points(js.prev_gray, g, js.positions, js.alive)
    P = js.map.points.shape[0]
    has3d = flow.valid & (js.track_ids >= 0) & js.map.point_valid[jnp.clip(js.track_ids, 0, P - 1)]
    k1, _ = jax.random.split(key)
    ka, kb = jax.random.split(k1)
    iters, n = jcfg.ransac.pnp_iters, has3d.shape[0]
    idx = T(jransac._sample_indices(ka, iters, 6, jnp.sum(has3d), n))
    idx3 = T(jransac._sample_indices(kb, max(iters // 4, 1), 3, jnp.sum(has3d), n))
    out, st = klt.klt_step(None, s, T(imgs[4]), cfg, sample_idx=idx, sample_idx3=idx3)

    assert int(st.num_pnp_inliers) == int(jst.num_pnp_inliers) > 30
    assert int(st.num_tracked) == int(jst.num_tracked)
    assert int(st.num_new_points) == int(jst.num_new_points)
    for f in ("alive", "track_ids"):
        np.testing.assert_array_equal(N(getattr(out, f)), N(getattr(jout, f)), err_msg=f)
    alive = N(out.alive)
    np.testing.assert_allclose(N(out.positions)[alive], N(jout.positions)[alive], atol=1e-3)
    for f in ("obs_mask", "point_valid", "cam_valid", "num_points", "num_cams"):
        np.testing.assert_array_equal(N(getattr(out.map, f)), N(getattr(jout.map, f)), err_msg=f)
    cam = int(out.map.num_cams) - 1
    np.testing.assert_allclose(N(out.map.poses[cam]), N(jout.map.poses[cam]), atol=1e-4)
    np.testing.assert_allclose(float(st.reproj_error), float(jst.reproj_error), rtol=1e-3)


def test_klt_sfm_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the cuda default runs here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        klt.KltSfM(config.SfmConfig())
