"""The port's track-based global pipeline (models/tracks.py) against JAX.

Tolerances. ``chain_tracks`` on a chain of three known homographies:
tracks within 1e-4 px of the JAX package's, validity identical.
``GlobalSfM.run`` on a 4-view plane at 320x240 (tests/test_tracks_exhaustive.py's
scene and bounds): 4/4 cameras, more than 100 points, a global BA cost
below 4 px^2, and the final sweep grows the map. ``final_sweep`` from one
state in both packages (the port's run, carried into the JAX package):
the swept point counts agree within 1% (detection agrees within 1% of the
keypoints, tests/test_torch_sift.py) and every swept point is finite.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import J, N, T

from sfm_mvs_tpu.models import map_store as jms
from sfm_mvs_tpu.models import tracks as jtracks
from sfm_mvs_tpu.utils import config as jconfig
from sfm_mvs_tpu_torch.models import ba, tracks
from sfm_mvs_tpu_torch.utils import config, convert
from sfm_mvs_tpu_torch.utils.synthetic import render_plane_sequence


def _cfgs(K):
    def build(c):
        return c.SfmConfig(
            fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
            downscale=1,
            frontend=c.FrontendConfig(max_features=1024, num_octaves=3, upsample_input=True,
                                      contrast_threshold=0.015, lowe_ratio=0.75),
            ransac=c.RansacConfig(essential_iters=512, pnp_iters=512, homography_iters=512),
            map=c.MapConfig(max_cameras=8, max_points=16384))

    return build(config), build(jconfig)


def test_chain_tracks_matches_jax():
    rng = np.random.default_rng(1)
    kp = rng.uniform(20, 300, (48, 2)).astype(np.float32)
    Hs = np.stack([np.array([[1.0 + 0.03 * k, 0.01, 3.0 * k], [-0.02, 0.98, -2.0],
                             [1e-5 * k, -1e-5, 1.0]]) for k in range(1, 4)]).astype(np.float32)
    valid = rng.random(48) > 0.1
    ref, ref_v = jtracks.chain_tracks(J(kp), J(valid), J(Hs), jnp.asarray([320.0, 240.0]))
    ours, ours_v = tracks.chain_tracks(T(kp), T(valid), T(Hs), (320, 240))
    assert ours.shape == (4, 48, 2)
    np.testing.assert_allclose(N(ours), N(ref), atol=1e-4)
    np.testing.assert_array_equal(N(ours_v), N(ref_v))
    np.testing.assert_array_equal(N(ours)[-1], kp)
    assert 0 < N(ours_v).sum() < N(ours_v).size


@pytest.fixture(scope="module")
def plane():
    imgs, Rt_gt, K = render_plane_sequence(num_cameras=4, image_size=(320, 240),
                                           arc_degrees=18, radius=6.0)
    cfg, jcfg = _cfgs(K)
    g = tracks.GlobalSfM(cfg, device="cpu")
    state = g.run(imgs, run_ba=True)
    return imgs, cfg, jcfg, g, state


def test_global_sfm_on_plane_sequence(plane):
    imgs, _, _, g, state = plane
    assert int(state.cam_valid.sum()) == 4
    assert int(state.num_points) > 100
    assert float(ba._cost(ba.problem_from_map(state))) < 4.0  # mean squared px
    events = [s for s in g.stats if s.get("event") == "global_ba"]
    assert len(events) == 1 and events[0]["cost_after"] <= events[0]["cost_before"]
    assert [s["frame"] for s in g.stats if "frame" in s] == [1, 2, 3]
    assert g.tracks.shape[:2] == (4, 1024) and g.track_valid.dtype == torch.bool


def test_final_sweep_matches_jax(plane):
    imgs, cfg, jcfg, g, state = plane
    jg = jtracks.GlobalSfM(jcfg)
    jg.state = jms.MapState(*[J(a) for a in convert.to_numpy(state)])
    jswept = jg.final_sweep(imgs)
    g.state = state
    swept = g.final_sweep(imgs)
    n0, n, nj = int(state.num_points), int(swept.num_points), int(jswept.num_points)
    assert n > n0 + 100
    assert abs((n - n0) - (nj - n0)) <= 0.01 * (nj - n0)
    assert torch.isfinite(swept.points[swept.point_valid]).all()
    assert int(swept.cam_valid.sum()) == 4
