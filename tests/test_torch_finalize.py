"""Finalize against the JAX package: map-store resizing and write-back
(models/map_store.py), culling (models/refine.py) and the densification
sweep (models/densify.py).

Integer ids, masks and remaps must match exactly and copied floats
bitwise; culling decides on residuals that agree to ~1e-4 px, far from the
4 px threshold on these inputs. The sweep's nearest-map-point distances are
|a|^2 + |b|^2 - 2 a.b on pixel coordinates up to ~1e3, so terms up to
~1.3e6 px^2 whose float32 spacing is 0.125 px^2; the two packages' matrix
products round differently, hence atol 0.5 px^2 on them and counts within
1%.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp

from _torch_parity import J, N, T, ba_map, jax_and_port

from sfm_mvs_tpu.models import densify as jdensify
from sfm_mvs_tpu.models import map_store as jms
from sfm_mvs_tpu.models import refine as jrefine
from sfm_mvs_tpu.ops import sift as jsift
from sfm_mvs_tpu.utils import config as jconfig
from sfm_mvs_tpu.utils.synthetic import make_scene
from sfm_mvs_tpu_torch.models import densify, map_store, refine
from sfm_mvs_tpu_torch.ops import sift
from sfm_mvs_tpu_torch.utils import config, convert


def _assert_maps_equal(ours, ref):
    for name, a, b in zip(ref._fields, ours, ref):
        np.testing.assert_array_equal(N(a), N(b), err_msg=name)


@pytest.fixture(scope="module")
def holed():
    """The BA scene with 0.3 px noise, 40% of its points invalidated and 5%
    of the observations moved by 10-40 px."""
    rng = np.random.default_rng(1)
    js = ba_map(obs_noise=0.3)
    pv = np.asarray(js.point_valid) & (rng.random(512) > 0.4)
    uv = np.asarray(js.obs_uv).copy()
    bad = np.asarray(js.obs_mask) & (rng.random((512, 8)) < 0.05)
    uv[bad] += rng.uniform(10, 40, (int(bad.sum()), 2)) * rng.choice([-1, 1], (int(bad.sum()), 2))
    return jax_and_port(js._replace(point_valid=jnp.asarray(pv), obs_uv=jnp.asarray(uv)))


def test_compact_shrink_grow(holed):
    js, ts = holed
    jc, jremap = jms.compact_points(js)
    tc, tremap = map_store.compact_points(ts)
    _assert_maps_equal(tc, jc)
    np.testing.assert_array_equal(N(tremap), N(jremap))
    live = int(tc.num_points)
    assert 150 < live < 256
    _assert_maps_equal(map_store.shrink_map(tc, 256), jms.shrink_map(jc, 256))
    assert map_store.shrink_map(tc, 512) is tc
    with pytest.raises(ValueError):
        map_store.shrink_map(tc, 128)
    _assert_maps_equal(map_store.grow_map(tc, 1024), jms.grow_map(jc, 1024))
    assert map_store.grow_map(tc, 512) is tc


def test_cull_map(holed):
    js, ts = holed
    jout = jrefine.cull_map(js)
    tout = refine.cull_map(ts)
    _assert_maps_equal(tout, jout)
    obs_before = int(map_store.num_observations(ts))
    assert int(map_store.num_observations(tout)) < obs_before - 10


def test_update_points_and_poses(holed):
    js, ts = holed
    rng = np.random.default_rng(2)
    ids = np.array([3, -1, 7, 600, 3, 10], np.int32)  # -1 and 600: dropped
    valid = np.array([1, 1, 1, 1, 0, 1], bool)
    X = rng.normal(size=(6, 3)).astype(np.float32)
    _assert_maps_equal(map_store.update_points(ts, T(ids), T(X), T(valid)),
                       jms.update_points(js, J(ids), J(X), J(valid)))
    cams = np.array([1, 9, 2], np.int32)
    poses = rng.normal(size=(3, 3, 4)).astype(np.float32)
    cv = np.array([1, 1, 0], bool)
    _assert_maps_equal(map_store.update_poses(ts, T(cams), T(poses), T(cv)),
                       jms.update_poses(js, J(cams), J(poses), J(cv)))


def test_nearest_map_point():
    """20,000 map points: three chunks (the JAX package's last one overlaps
    the one before it); 40 candidates sit exactly on map points, and one on
    a landmark listed twice, in chunks 0 and 1 (integer pixels, so both
    distances are exactly 0): the lower index wins the tie."""
    rng = np.random.default_rng(4)
    P, M = 20000, 400
    uv_map = (rng.random((P, 2)) * [968, 648]).astype(np.float32)
    depth = rng.uniform(1, 10, P).astype(np.float32)
    valid = rng.random(P) > 0.1
    uv_c = (rng.random((M, 2)) * [968, 648]).astype(np.float32)
    a, b = 100, 9000
    on = rng.choice(np.setdiff1d(np.flatnonzero(valid), [a, b]), 40, replace=False)
    uv_c[:40] = uv_map[on]
    uv_map[[a, b]] = uv_c[40] = (123.0, 45.0)
    valid[[a, b]] = True
    depth[b] = depth[a] + 1.0
    d_j, z_j = jdensify._nearest_map_point(J(uv_c), J(uv_map), J(depth), J(valid))
    d_t, z_t = densify._nearest_map_point(T(uv_c), T(uv_map), T(depth), T(valid))
    np.testing.assert_allclose(N(d_t), N(d_j), atol=0.5)
    assert (N(z_t) == N(z_j)).mean() > 0.99
    np.testing.assert_array_equal(N(z_t)[:40], depth[on])
    assert N(d_t)[40] == N(d_j)[40] == 0.0
    assert N(z_t)[40] == N(z_j)[40] == depth[a]
    # float64 brute force: the winner's depth where the best is clear
    d2 = ((uv_c[:, None, :].astype(np.float64) - uv_map[None]) ** 2).sum(-1)
    d2[:, ~valid] = np.inf
    srt = np.sort(d2, axis=1)
    clear = srt[:, 1] - srt[:, 0] > 0.1
    np.testing.assert_array_equal(N(z_t)[clear], depth[d2.argmin(1)][clear])


def _sweep_inputs():
    """Two views of 800 points of make_scene (968x648, f = 1200) with 0.2 px
    noise; descriptors shared per point plus per-view noise; view 1's slots
    shuffled, 1024 slots each. The map holds both cameras and the first 300
    points with their observations, which the sweep must not duplicate."""
    rng = np.random.default_rng(5)
    n, cap = 800, 1024
    scene = make_scene(num_points=n, num_cameras=3, arc_degrees=20)
    base = rng.normal(size=(n, 128)).astype(np.float32)
    feats, uvs = [], []
    for c, perm in ((0, np.arange(n)), (1, rng.permutation(n))):
        uv, _ = scene.project(c)
        uv = (uv + rng.normal(scale=0.2, size=uv.shape)).astype(np.float32)
        uvs.append(uv)
        d = base + 0.05 * rng.normal(size=base.shape).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        xy = np.zeros((cap, 2), np.float32)
        desc = np.zeros((cap, 128), np.float32)
        xy[:n], desc[:n] = uv[perm], d[perm]
        valid = np.arange(cap) < n
        z = np.zeros(cap, np.float32)
        feats.append(jsift.Features(xy=xy, scale=z, angle=z, response=z, desc=desc, valid=valid))
    jstate = jms.init_map(jnp.asarray(scene.K), jconfig.MapConfig(max_cameras=8, max_points=4096))
    for c in (0, 1):
        jstate, _ = jms.append_camera(jstate, jnp.asarray(scene.Rt[c]))
    old = np.arange(n) < 300
    jstate, pids = jms.append_points(jstate, jnp.asarray(scene.points), jnp.zeros((n, 3)),
                                     jnp.asarray(old))
    for c in (0, 1):
        jstate = jms.append_observations(jstate, c, pids, jnp.asarray(uvs[c]), jnp.asarray(old))
    K = scene.K

    def cfg(c):
        return c.SfmConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                           cy=float(K[1, 2]), downscale=1,
                           frontend=c.FrontendConfig(lowe_ratio=0.75),
                           map=c.MapConfig(max_cameras=8, max_points=4096),
                           sweep=c.SweepConfig(enabled=True))

    img = np.full((648, 968, 3), 100.0, np.float32)
    return jstate, feats, img, cfg(jconfig), cfg(config)


def test_sweep_pair():
    jstate, feats, img, jcfg, cfg = _sweep_inputs()
    js, ts = jax_and_port(jstate)
    jf = [jsift.Features(*[jnp.asarray(a) for a in f]) for f in feats]
    tf = [convert.to_torch(f) for f in feats]
    jout, jn = jdensify.sweep_pair(js, jnp.int32(0), jnp.int32(1), jf[0], jf[1], J(img), jcfg)
    tout, tn = densify.sweep_pair(ts, 0, 1, tf[0], tf[1], T(img), cfg)
    jn, tn = int(jn), int(tn)
    assert 400 < jn <= 500  # the 500 new points, less ratio-test losses
    assert abs(tn - jn) <= 0.01 * jn
    assert int(tout.num_points) == 300 + tn
    n_obs = int(map_store.num_observations(tout))
    assert abs(n_obs - int(jms.num_observations(jout))) <= 0.01 * n_obs
    assert n_obs == 600 + 2 * tn
    new = slice(300, 300 + min(tn, jn))
    assert np.median(np.abs(N(tout.points)[new] - N(jout.points)[new])) < 1e-4


def test_densify_sweep_dedups_a_second_pass():
    """A second pass over the same pair (pair_strides=(1, 1)) finds its
    candidates already in the map; redetect_for_sweep detects with the
    sweep's frontend overrides."""
    jstate, feats, img, _, cfg = _sweep_inputs()
    _, ts = jax_and_port(jstate)
    tf = [convert.to_torch(f) for f in feats]
    once, added_once = densify.densify_sweep(ts, tf, [img, img], cfg)
    assert added_once == int(once.num_points) - 300 > 400
    cfg2 = dataclasses.replace(cfg, sweep=dataclasses.replace(cfg.sweep, pair_strides=(1, 1)))
    _, added_twice = densify.densify_sweep(ts, tf, [img, img], cfg2)
    assert added_once <= added_twice <= 1.01 * added_once

    assert densify.sweep_frontend_config(cfg) is cfg.frontend
    sw = dataclasses.replace(cfg, sweep=dataclasses.replace(cfg.sweep, max_features=64,
                                                            contrast_threshold=0.01))
    fc = densify.sweep_frontend_config(sw)
    assert (fc.max_features, fc.contrast_threshold) == (64, 0.01)
    g = np.random.default_rng(0).random((64, 96)).astype(np.float32)
    f, = densify.redetect_for_sweep([g], sw, device="cpu")
    np.testing.assert_array_equal(N(f.xy), N(sift.detect_and_compute(T(g), fc).xy))
    assert f.xy.shape == (64, 2)
