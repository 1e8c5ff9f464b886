"""The ported slice as a whole against the JAX package: detect -> match ->
two-view bootstrap -> per-frame PnP registration, with BA off and on, and
finalize with the densification sweep.

Staircase at 320x240, 4 cameras over 20 degrees; max_features=512,
num_octaves=3, contrast 0.015, ratio 0.75, 256 RANSAC iterations,
MapConfig(8, 4096).

(a) One ``register_frame`` in each package from the same state: the JAX
    package's bootstrap state, converted (utils/convert.py), and the same
    features. Matching is deterministic, so match and tracked counts are
    identical; the RANSAC samples differ (jax.random vs torch.Generator), so
    PnP inliers agree within 2%.
(b) ``IncrementalSfM.run`` in both packages registers every camera with
    ATE < 0.05, rotation error < 1 deg and every frame's reprojection error
    < 1 px (the thresholds of tests/test_pipeline.py).
(c) The same with a global BA after every frame, then ``finalize()`` with
    the densification sweep: both reach ATE < 0.05 and a final cost below
    1 px^2, with point counts within 10% (RANSAC draws differ, so the maps
    differ by a few points before the sweep).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from _torch_parity import J, N, T

from sfm_mvs_tpu.models import incremental as jinc
from sfm_mvs_tpu.ops import sift as jsift
from sfm_mvs_tpu.utils import config as jconfig
from sfm_mvs_tpu_torch.models import incremental
from sfm_mvs_tpu_torch.utils import config, convert, evaluate
from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence


def _configs(K):
    def build(c):
        return c.SfmConfig(
            fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
            downscale=1,
            frontend=c.FrontendConfig(max_features=512, num_octaves=3,
                                      contrast_threshold=0.015, lowe_ratio=0.75),
            ransac=c.RansacConfig(essential_iters=256, pnp_iters=256, homography_iters=256),
            map=c.MapConfig(max_cameras=8, max_points=4096),
        )

    return build(config), build(jconfig)


@pytest.fixture(scope="module")
def scene():
    imgs, Rt_gt, K = render_staircase_sequence(num_cameras=4, arc_degrees=20,
                                               image_size=(320, 240))
    cfg, jcfg = _configs(K)
    bgr = [np.repeat((g * 255.0)[..., None], 3, axis=-1).astype(np.float32) for g in imgs]
    return imgs, bgr, Rt_gt, cfg, jcfg


def test_register_frame_from_converted_state(scene):
    imgs, bgr, _, cfg, jcfg = scene
    # The same calls (and static arguments) as the JAX driver's run, so the
    # compiled functions are shared with the run below.
    feats = [jsift.detect_and_compute(J(imgs[i]), jcfg.frontend) for i in range(3)]
    key, k0 = jax.random.split(jax.random.PRNGKey(0))
    pstate_j, _, _ = jinc.init_from_bootstrap(k0, feats[0], feats[1], J(bgr[1]),
                                              J(jcfg.intrinsic_matrix()), jcfg,
                                              return_track0=True)
    _, ki = jax.random.split(key)
    new_j, st_j = jinc.register_frame(ki, pstate_j, feats[2], J(bgr[2]), jcfg)

    def leaves(x):
        return type(x)(*[leaves(v) if isinstance(v, tuple) else np.asarray(v) for v in x])

    pstate_t = convert.to_torch(leaves(pstate_j))
    f2 = convert.to_torch(leaves(feats[2]))
    gen = torch.Generator().manual_seed(0)
    new_t, st_t = incremental.register_frame(gen, pstate_t, f2, T(bgr[2]), cfg)

    assert int(st_t.num_matches) == int(st_j.num_matches) > 50
    assert int(st_t.num_tracked) == int(st_j.num_tracked) > 30
    n_t, n_j = int(st_t.num_pnp_inliers), int(st_j.num_pnp_inliers)
    assert abs(n_t - n_j) <= 0.02 * n_j
    assert bool(st_t.accepted) and bool(st_j.accepted)
    assert float(st_t.reproj_error) < 1.0
    # the matched frame's feature slots that continue a track agree, up to
    # the few PnP inliers the two RANSAC draws classify differently
    tr_t, tr_j = N(new_t.prev_track), N(new_j.prev_track)
    same = (tr_t >= 0) == (tr_j >= 0)
    assert same.mean() > 0.98
    old = (tr_j >= 0) & (tr_j < int(pstate_j.map.num_points))
    np.testing.assert_array_equal(tr_t[old & (tr_t >= 0)], tr_j[old & (tr_t >= 0)])


def _check_run(poses, Rt_gt, stats):
    assert len(poses) == len(Rt_gt)
    assert evaluate.ate_rmse(poses, Rt_gt) < 0.05
    assert evaluate.rotation_errors_deg(poses, Rt_gt).max() < 1.0
    for s in stats:
        assert s["reproj_error"] < 1.0


def test_incremental_run_both_packages(scene):
    imgs, _, Rt_gt, cfg, jcfg = scene
    jsfm = jinc.IncrementalSfM(jcfg)
    jstate = jsfm.run(imgs)
    _check_run(np.asarray(jstate.poses)[np.asarray(jstate.cam_valid)], Rt_gt, jsfm.stats)

    sfm = incremental.IncrementalSfM(cfg, device="cpu")
    state = sfm.run(imgs)
    _check_run(N(state.poses)[N(state.cam_valid)], Rt_gt, sfm.stats)
    assert int(state.num_points) > 100
    # the bootstrap pair's matches are the same in both
    assert sfm.stats[0]["matches"] == jsfm.stats[0]["matches"]


def test_ba_and_finalize_both_packages(scene):
    """``ba.enabled`` (a global BA after every frame), then ``finalize()``
    with the sweep grown to 8192 points, in both packages."""
    imgs, _, Rt_gt, cfg, jcfg = scene

    def with_ba(c, mod):
        return dataclasses.replace(c, ba=mod.BaConfig(enabled=True),
                                   sweep=mod.SweepConfig(enabled=True, grow_points=8192))

    results = []
    for sfm in (jinc.IncrementalSfM(with_ba(jcfg, jconfig)),
                incremental.IncrementalSfM(with_ba(cfg, config), device="cpu")):
        run = sfm.run(imgs)
        _check_run(N(run.poses)[N(run.cam_valid)], Rt_gt, sfm.stats)
        state = sfm.finalize()
        assert evaluate.ate_rmse(N(state.poses)[N(state.cam_valid)], Rt_gt) < 0.05
        assert sfm.finalize_info["final_cost"] < 1.0
        assert state.points.shape[0] == 8192
        n_points = int(N(state.point_valid).sum())
        assert n_points > int(N(run.point_valid).sum())  # the sweep added points
        results.append(n_points)
    n_jax, n_port = results
    assert abs(n_port - n_jax) <= 0.1 * n_jax


def test_unported_options_raise(scene):
    imgs, _, _, cfg, _ = scene

    # bootstrap="auto" and checkpoints are ported (test_torch_auto_bootstrap.py,
    # test_torch_checkpoint.py); loop closure and BA of the intrinsics wait.
    for bad in (dataclasses.replace(cfg, loop_close_pairs=2),
                dataclasses.replace(cfg, ba=config.BaConfig(enabled=True, refine_intrinsics=True)),
                dataclasses.replace(cfg, ba=config.BaConfig(
                    enabled=True, refine_intrinsics_per_camera=True))):
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            incremental.IncrementalSfM(bad, device="cpu").run(imgs)
