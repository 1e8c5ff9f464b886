"""Loop closure and duplicate merging in the port against the JAX package.

Tolerances. ``merge_duplicate_points`` on the planted-duplicate map of
tests/test_compact.py: state, remap and count bitwise, both passes.
``finalize_map`` with merging on a BA map with planted duplicates: merged
counts and the composed remap equal, robust and round costs rtol 1e-3.
``inject_reobservations`` on a registered 5-frame map, with the JAX
package's RANSAC samples injected: obs_mask bitwise and counts equal (the
matches are deterministic). ``strongest_loop_pairs`` on one view graph:
equal lists. ``IncrementalSfM.finalize`` with ``loop_close_pairs=2`` on the
5-frame distorted scene of tests/test_distortion.py (undistorted at
detection): 5/5 cameras, ATE < 0.05, loop-closure observations injected.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from _torch_parity import J, N, T, ba_map, jax_and_port

from sfm_mvs_tpu.models import exhaustive as jex
from sfm_mvs_tpu.models import map_store as jms
from sfm_mvs_tpu.models import refine as jrefine
from sfm_mvs_tpu.ops import matching as jmatching
from sfm_mvs_tpu.ops import ransac as jransac
from sfm_mvs_tpu.utils import config as jconfig
from sfm_mvs_tpu_torch.models import exhaustive, map_store, refine
from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM
from sfm_mvs_tpu_torch.utils import config, convert, evaluate
from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence

DIST = (-0.18, 0.03)


def _planted_map():
    """tests/test_compact.py's map: A in three chains, B alone, C twice in
    conflict (30 px apart in camera 0)."""
    K = jnp.asarray([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]], jnp.float32)
    state = jms.init_map(K, jconfig.MapConfig(max_cameras=4, max_points=64))
    for _ in range(4):
        state, _ = jms.append_camera(state, jnp.eye(3, 4))
    pts = np.array([[0.0, 0.0, 5.0], [0.005, 0.0, 5.0], [1.0, 0.0, 5.0], [2.0, 0.0, 5.0],
                    [2.004, 0.0, 5.0], [0.008, 0.0, 5.0]], np.float32)
    state, _ = jms.append_points(state, jnp.asarray(pts), jnp.zeros((6, 3)), jnp.ones(6, bool))
    uv = np.zeros((64, 4, 2), np.float32)
    mask = np.zeros((64, 4), bool)
    mask[0, :2], uv[0, :2] = True, [10.0, 10.0]
    mask[1, 2:], uv[1, 2:] = True, [11.0, 10.0]
    mask[5, 1], uv[5, 1] = True, [10.5, 10.0]
    mask[2, 0], uv[2, 0] = True, [50.0, 50.0]
    mask[3, 0], uv[3, 0] = True, [80.0, 40.0]
    mask[4, 0], uv[4, 0] = True, [110.0, 40.0]
    return state._replace(obs_uv=jnp.asarray(uv), obs_mask=jnp.asarray(mask))


def _assert_same(ours, ref):
    for f in ref._fields:
        np.testing.assert_array_equal(N(getattr(ours, f)), N(getattr(ref, f)), err_msg=f)


def test_merge_duplicate_points_bitwise():
    js, ts = jax_and_port(_planted_map())
    counts = []
    for _ in range(2):  # pairs, then the chain left over
        js, jremap, jn = jms.merge_duplicate_points(js, jnp.asarray(0.02), jnp.asarray(4.0))
        ts, remap, n = map_store.merge_duplicate_points(ts, 0.02, 4.0)
        _assert_same(ts, js)
        np.testing.assert_array_equal(N(remap), N(jremap))
        assert int(n) == int(jn)
        counts.append(int(n))
    assert counts == [1, 1]
    assert not N(ts.point_valid)[[1, 5]].any() and N(ts.point_valid)[[0, 2, 3, 4]].all()
    assert N(ts.obs_mask)[0].sum() == 4


def _duplicated_ba_map():
    """tests/test_ba.py's map (5 cameras, 300 points, 0.3 px noise) with
    points 0..39 split in two: cameras 0-2 keep the original, cameras 3-4
    observe a copy 1e-3 away in slots 300..339."""
    s = ba_map(obs_noise=0.3)
    pts, pv = np.asarray(s.points).copy(), np.asarray(s.point_valid).copy()
    uv, m = np.asarray(s.obs_uv).copy(), np.asarray(s.obs_mask).copy()
    src, dup = np.arange(40), 300 + np.arange(40)
    pts[dup] = pts[src] + 1e-3
    pv[dup] = True
    uv[dup, 3:5], m[dup, 3:5] = uv[src, 3:5], True
    m[src, 3:5] = False
    return s._replace(points=jnp.asarray(pts), point_valid=jnp.asarray(pv), obs_uv=jnp.asarray(uv),
                      obs_mask=jnp.asarray(m), num_points=jnp.asarray(340, jnp.int32))


def test_finalize_map_merges_duplicates():
    js, ts = jax_and_port(_duplicated_ba_map())
    kw = dict(max_iterations=6, robust_iterations=4, cg_iters=20, merge_eps_3d=0.05)
    jout, jinfo = jrefine.finalize_map(js, **kw)
    tout, info = refine.finalize_map(ts, **kw)
    assert info["merged_points"] == jinfo["merged_points"] == 40
    np.testing.assert_array_equal(N(info["point_remap"]), N(jinfo["point_remap"]))
    for k in ("robust_cost", "round0_cost", "round1_cost"):
        np.testing.assert_allclose(info[k], jinfo[k], rtol=1e-3, err_msg=k)
    assert info["points"] == jinfo["points"]
    np.testing.assert_array_equal(N(tout.obs_mask), N(jout.obs_mask))


def _cfgs(K, **kw):
    def build(c):
        return c.SfmConfig(
            fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
            downscale=1, k1=DIST[0], k2=DIST[1],
            frontend=c.FrontendConfig(max_features=512, num_octaves=3, upsample_input=True,
                                      contrast_threshold=0.015, lowe_ratio=0.75),
            ransac=c.RansacConfig(essential_iters=256, pnp_iters=256, homography_iters=256),
            map=c.MapConfig(max_cameras=8, max_points=4096), **kw)

    return build(config), build(jconfig)


@pytest.fixture(scope="module")
def registered():
    """The port's driver on the distorted 5-frame scene (loop closure on),
    the map and stored per-camera data before finalize, then finalize."""
    imgs, Rt_gt, K = render_staircase_sequence(num_cameras=5, arc_degrees=24,
                                               image_size=(320, 240), dist=DIST)
    cfg, jcfg = _cfgs(K, loop_close_pairs=2)
    sfm = IncrementalSfM(cfg, device="cpu")
    sfm.run(imgs)
    before = (sfm.state.map, list(sfm._cam_feats), list(sfm._cam_tracks), list(sfm._cam_gray))
    state = sfm.finalize()
    return dict(before=before, after=state, sfm=sfm, Rt_gt=Rt_gt, cfg=cfg, jcfg=jcfg)


def test_finalize_with_loop_closure(registered):
    state, sfm = registered["after"], registered["sfm"]
    poses = N(state.poses)[N(state.cam_valid)]
    assert len(poses) == 5
    assert evaluate.ate_rmse(poses, registered["Rt_gt"]) < 0.05
    info = sfm.finalize_info
    assert info["loop_closure_obs"] > 0
    assert "merged_points" in info and "robust_cost" in info and "point_remap" not in info
    assert info["round1_cost"] < 1.0
    # the stored track ids still point at live points after compaction + merging
    for t in sfm._cam_tracks:
        ids = N(t)[N(t) >= 0]
        assert N(state.point_valid)[ids].mean() > 0.9


def test_strongest_loop_pairs_match_jax(registered):
    _, feats, _, gray = registered["before"]
    graph = exhaustive.build_view_graph(gray, registered["cfg"], feats=feats)
    pairs = exhaustive.strongest_loop_pairs(graph, 3)
    assert pairs == jex.strongest_loop_pairs(graph, 3)
    assert pairs and all(j - i >= 3 for i, j in pairs)
    assert exhaustive.strongest_loop_pairs(graph, 3, min_inliers=10**6) == []


@pytest.mark.parametrize("verify", [False, True])
def test_inject_reobservations_match_jax(registered, verify):
    state, feats, tracks, _ = registered["before"]
    cfg, jcfg = registered["cfg"], registered["jcfg"]
    i, j = 0, 3
    jstate = jms.MapState(*[J(a) for a in convert.to_numpy(state)])
    fi, fj = (jex.Features(*[J(a) for a in convert.to_numpy(f)]) for f in (feats[i], feats[j]))
    key = jax.random.PRNGKey(5)
    kw = dict(max_err_px=64.0, epipolar_verify=True) if verify else {}
    jout, jn = jex.inject_reobservations(jstate, jnp.asarray(i), jnp.asarray(j), fi, fj,
                                         J(tracks[i]), jcfg, key=key, **kw)
    idx = None
    if verify:  # the draw JAX's ransac_essential makes inside
        m = jmatching.knn_match(fi.desc, fj.desc, fi.valid, fj.valid, ratio=jcfg.frontend.lowe_ratio)
        k1, _ = jax.random.split(key)
        idx = T(jransac._sample_indices(k1, jcfg.ransac.essential_iters, 8, jnp.sum(m.valid),
                                        m.valid.shape[0]))
    out, n = exhaustive.inject_reobservations(state, i, j, feats[i], feats[j], tracks[i], cfg,
                                              sample_idx=idx, **kw)
    assert int(n) == int(jn) > 0
    np.testing.assert_array_equal(N(out.obs_mask), N(jout.obs_mask))
    np.testing.assert_allclose(N(out.obs_uv), N(jout.obs_uv), atol=1e-5)
    if verify:
        with pytest.raises(ValueError, match="generator"):
            exhaustive.inject_reobservations(state, i, j, feats[i], feats[j], tracks[i], cfg,
                                             epipolar_verify=True)
