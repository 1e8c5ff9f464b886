"""Plane-sweep MVS against the JAX package (models/mvs.py).

Tolerances, and why:

- The elementwise helpers (box filter, 2x average pool, 3x3 min/max pool,
  bilinear and nearest taps, K scaling, back-projection) agree to 1e-6.
  The box filter takes differences of float32 cumulative sums; the port
  sums in XLA's order (blocks of 16), so it is bitwise equal.
- The linear upsample (jax.image.resize against F.interpolate) to 2e-6 on
  values in [0, 1): the two compute the same taps with other roundings.
- _sweep_select's per-hypothesis costs to rtol 1e-5 + atol 2e-6 (two
  float32 spacings of the ~8-unit prefix sums the box filter differences),
  and the argmin over hypotheses identical wherever the best two costs
  differ by more than 1e-6; the in-image neighbor counts agree but for a
  tap exactly on the image border (< 1e-4 of them).
- plane_sweep_depth: valid masks agree on >= 99% of pixels and confidence
  to 1e-5. The depth is held to the JAX package's own noise floor, not to
  1e-4: the coarse sweep samples with nearest taps, so neighbouring
  hypotheses often sample the same pixels and tie to the last bit, and
  the chosen plateau entry then moves with any rounding difference.
  Measured (CPU): JAX against itself with +-1 ulp of noise on the
  reference image agrees within 1e-4 on only ~20% of pixels (median
  relative difference 0.7-0.8%, 90th percentile 4-6%); the port against
  JAX shows the same spread (~21%, 0.6%, 3.7%). So the port must stay
  within median 1.2% / 90th percentile 8% of JAX, and its median error
  against the renderer's ground truth within 0.5 points of JAX's.
- geometric_consistency (min_conf = 0.5, edge trim): masks identical,
  fused depths to 1e-5 relative. The JAX function is driven through
  __wrapped__: its public jit cannot take min_conf > 0 (ROADMAP C4).
- _depth_ranges to rtol 1e-5. densify_map's point count within 6% of
  JAX's (not 2%: JAX's own count moves by 4.9% at this size under +-1 ulp
  of input noise, 2028 -> 2128 points, measured), with tests/test_mvs.py's
  ground-truth checks.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_parity import J, N, T, ba_map, jax_and_port

from sfm_mvs_tpu.models import map_store as jms
from sfm_mvs_tpu.models import mvs as jmvs
from sfm_mvs_tpu.utils.config import MapConfig
from sfm_mvs_tpu.utils.synthetic import render_staircase_sequence
from sfm_mvs_tpu_torch.models import mvs
from sfm_mvs_tpu_torch.utils import convert


def _scene(size, dist=(0.0, 0.0)):
    W, H = size
    return render_staircase_sequence(num_cameras=3, arc_degrees=10, image_size=size,
                                     focal=200.0 * W / 160.0, return_depth=True, dist=dist)


@pytest.fixture(scope="module")
def scene():
    return _scene((160, 120))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


def test_elementwise_helpers(rng):
    x = rng.random((3, 37, 50)).astype(np.float32)
    np.testing.assert_array_equal(N(mvs._box_filter(T(x), 2)), np.asarray(jmvs._box_filter(J(x), 2)))
    np.testing.assert_allclose(N(mvs._downsample2(T(x))), np.asarray(jmvs._downsample2(J(x))),
                               atol=1e-6)
    for op, jop in ((torch.minimum, jax.lax.min), (torch.maximum, jax.lax.max)):
        np.testing.assert_array_equal(N(mvs._pool3(T(x[0]), op)),
                                      np.asarray(jmvs._pool3(J(x[0]), jop)))
    img = x[0]
    px = rng.uniform(-3, 53, 2000).astype(np.float32)
    py = rng.uniform(-3, 40, 2000).astype(np.float32)
    px[:20] = np.arange(20) + 0.5  # round-half cases
    for fn, jfn in ((mvs._bilinear_sample, jmvs._bilinear_sample),
                    (mvs._nearest_sample, jmvs._nearest_sample)):
        v, inside = fn(T(img), T(px), T(py))
        jv, jinside = jfn(J(img), J(px), J(py))
        np.testing.assert_allclose(N(v), np.asarray(jv), atol=1e-6)
        np.testing.assert_array_equal(N(inside), np.asarray(jinside))
    K = np.array([[200.0, 0, 80], [0, 210.0, 60], [0, 0, 1]], np.float32)
    for s in (2.0, 4.0):
        np.testing.assert_allclose(N(mvs._scale_K(T(K), s)), np.asarray(jmvs._scale_K(J(K), s)),
                                   atol=1e-6)
    small = rng.random((1, 37, 50)).astype(np.float32)
    for size in ((75, 100), (74, 101)):
        np.testing.assert_allclose(
            N(mvs._resize_linear(T(small), size))[0],
            np.asarray(jax.image.resize(J(small[0]), size, "linear")), atol=2e-6)


@pytest.mark.parametrize("color", ["gray", "bgr", "none", "dist"])
def test_backproject_depth(scene, color):
    imgs, Rt, K, depths = scene
    H, W = imgs[1].shape
    dm = (depths[1], np.ones((H, W), np.float32), depths[1] > 0)
    img = {"gray": imgs[1], "bgr": np.repeat(imgs[1][..., None] * 255.0, 3, -1),
           "none": None, "dist": imgs[1]}[color]
    dist = np.array([0.03, -0.01], np.float32) if color == "dist" else None
    out = mvs.backproject_depth(mvs.DepthMap(*[T(a) for a in dm]), T(Rt[1]), T(K),
                                None if img is None else T(img), stride=3,
                                dist=None if dist is None else T(dist))
    ref = jmvs.backproject_depth(jmvs.DepthMap(*[J(a) for a in dm]), J(Rt[1]), J(K),
                                 None if img is None else J(img), stride=3,
                                 dist=None if dist is None else J(dist))
    assert N(out[0]).shape == (40 * 54, 3)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(N(a), np.asarray(b), rtol=1e-6, atol=1e-6)


def _sweep_inputs(scene):
    imgs, Rt, K, _ = scene
    ref, nb = imgs[1], np.stack([imgs[0], imgs[2]])
    ref_zm = ref - np.asarray(jmvs._box_filter(J(ref), 2))
    nb_zm = nb - np.asarray(jmvs._box_filter(J(nb), 2))
    R_ref, t_ref = Rt[1][:, :3], Rt[1][:, 3]
    Rn, tn = Rt[[0, 2]][:, :, :3], Rt[[0, 2]][:, :, 3]
    R_rel = np.einsum("mij,kj->mik", Rn, R_ref).astype(np.float32)
    t_rel = (tn - np.einsum("mij,j->mi", R_rel, t_ref)).astype(np.float32)
    offs = np.asarray(jnp.linspace(1.0 / 12.0, 1.0 / 5.0, 24))
    return ref_zm, nb_zm, K.astype(np.float32), R_rel, t_rel, np.zeros_like(ref), offs


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_sweep_select(scene, mode):
    ref_zm, nb_zm, K, R_rel, t_rel, center, offs = _sweep_inputs(scene)
    jsel = jax.jit(jmvs._sweep_select, static_argnames=("cost_radius", "sample_mode"))

    def both(o):
        ours = mvs._sweep_select(T(ref_zm), T(nb_zm), T(K), T(R_rel), T(t_rel), T(center),
                                 T(o), 2, sample_mode=mode)
        ref = jsel(J(ref_zm), J(nb_zm), J(K), J(R_rel), J(t_rel), J(center), J(o),
                   cost_radius=2, sample_mode=mode)
        return [N(a) for a in ours], [np.asarray(a) for a in ref]

    # The cost volume, one hypothesis per call (a single offset's cost is
    # its best and its mean).
    vol = [both(offs[d:d + 1]) for d in range(len(offs))]
    cost = np.stack([o[1] for o, _ in vol])
    jcost = np.stack([r[1] for _, r in vol])
    np.testing.assert_allclose(cost, jcost, rtol=1e-5, atol=2e-6)
    # Neighbor counts: a warped tap exactly on the image border may fall
    # either side of it (1 of 460,800 taps at nearest, measured).
    assert (np.stack([o[3] for o, _ in vol]) != np.stack([r[3] for _, r in vol])).mean() < 1e-4
    srt = np.sort(jcost, axis=0)
    clear = (srt[1] - srt[0]) > 1e-6
    assert clear.mean() > 0.3
    np.testing.assert_array_equal(np.argmin(cost, 0)[clear], np.argmin(jcost, 0)[clear])

    ours, ref = both(offs)
    for name, a, b in zip(["best_cost", "mean_cost"], ours[1:3], ref[1:3]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6, err_msg=name)
    assert (ours[3] != ref[3]).mean() < 1e-3


@pytest.mark.parametrize("size,dist", [((160, 120), None), ((200, 150), None),
                                       ((200, 150), (0.04, -0.02))])
def test_plane_sweep_depth(size, dist):
    imgs, Rt, K, depths = _scene(size, dist=dist or (0.0, 0.0))
    d = None if dist is None else np.asarray(dist, np.float32)
    args = (imgs[1], np.stack([imgs[0], imgs[2]]), Rt[1], Rt[[0, 2]], K)
    ours = mvs.plane_sweep_depth(*[T(a) for a in args], 5.0, 12.0, num_depths=64,
                                 dist=None if d is None else T(d))
    ref = jmvs.plane_sweep_depth(*[J(a) for a in args], jnp.asarray(5.0), jnp.asarray(12.0),
                                 num_depths=64, dist=None if d is None else J(d))
    depth, conf, valid = (N(a) for a in ours)
    jdepth, jconf, jvalid = (np.asarray(a) for a in ref)
    assert (valid == jvalid).mean() >= 0.99
    np.testing.assert_allclose(conf, jconf, atol=1e-5)
    both = valid & jvalid
    rel = np.abs(depth - jdepth)[both] / jdepth[both]
    assert np.median(rel) < 0.012 and np.percentile(rel, 90) < 0.08, np.percentile(rel, [50, 90])
    gt = depths[1]
    ok = both & (gt > 0)
    err = np.median(np.abs(depth[ok] - gt[ok]) / gt[ok])
    jerr = np.median(np.abs(jdepth[ok] - gt[ok]) / gt[ok])
    assert abs(err - jerr) < 0.005 and err < 0.03, (err, jerr)


def test_geometric_consistency(scene, rng):
    """Neighbors' depth maps from ground truth with 1% noise and holes; one
    padded neighbor slot; min_conf and the near-side edge trim on."""
    imgs, Rt, K, depths = scene
    H, W = imgs[1].shape
    noisy = [np.where(d > 0, d * (1 + 0.01 * rng.standard_normal(d.shape)), 0.0)
             .astype(np.float32) for d in depths]
    conf = rng.random((H, W)).astype(np.float32)
    valid = (depths[1] > 0) & (rng.random((H, W)) > 0.1)
    nbr_d = np.stack([noisy[0], noisy[2], noisy[0]])
    nbr_p = Rt[[0, 2, 0]]
    nbr_v = np.array([True, True, False])
    kw = dict(rel_tol=0.015, min_consistent=1, fuse_depths=True, edge_trim_rel=0.06,
              edge_trim_radius=3, free_space_rel=0.05, edge_keep_conf=0.75, min_conf=0.5)
    ours = mvs.geometric_consistency(
        mvs.DepthMap(T(noisy[1]), T(conf), T(valid)), T(Rt[1]), T(nbr_d), T(nbr_p), T(K),
        nbr_valid=T(nbr_v), **kw)
    ref = jmvs.geometric_consistency.__wrapped__(
        jmvs.DepthMap(J(noisy[1]), J(conf), J(valid)), J(Rt[1]), J(nbr_d), J(nbr_p), J(K),
        nbr_valid=J(nbr_v), **kw)
    v, jv = N(ours.valid), np.asarray(ref.valid)
    np.testing.assert_array_equal(v, jv)
    assert 0.1 < v.mean() < 0.6  # the floor, the vote and the trim all bite
    np.testing.assert_allclose(N(ours.depth)[v], np.asarray(ref.depth)[v], rtol=1e-5)
    np.testing.assert_array_equal(N(ours.confidence), conf)


def test_depth_ranges():
    js = ba_map()
    _, ts = jax_and_port(js)
    lo, hi = mvs._depth_ranges(ts)
    jlo, jhi = jmvs._depth_ranges(js)
    np.testing.assert_allclose(N(lo), np.asarray(jlo), rtol=1e-5)
    np.testing.assert_allclose(N(hi), np.asarray(jhi), rtol=1e-5)
    assert N(lo)[7] == pytest.approx(0.7) and N(hi)[7] == pytest.approx(14.0)  # empty slot


def test_densify_map(scene):
    """tests/test_mvs.py:62-92 on both packages: a sparse map seeded from GT
    depth, then the full two-pass densification."""
    imgs, Rt, K, depths_gt = scene
    state = jms.init_map(J(K), MapConfig(max_cameras=4, max_points=4096))
    for c in range(3):
        state, _ = jms.append_camera(state, J(Rt[c]))
    rng = np.random.default_rng(0)
    ys, xs = rng.integers(0, 120, 300), rng.integers(0, 160, 300)
    z = depths_gt[1][ys, xs]
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    Xw = (rays * z[:, None] - Rt[1][:, 3]) @ Rt[1][:, :3]
    state, _ = jms.append_points(state, J(Xw.astype(np.float32)), jnp.zeros((300, 3)),
                                 J(z > 0))
    jpts, jcols = jmvs.densify_map(imgs, state, num_depths=64, stride=2)
    ts = convert.to_torch(type(state)(*[np.asarray(a) for a in state]))
    pts, cols, dms = mvs.densify_map(imgs, ts, num_depths=64, stride=2, return_depth_maps=True)
    assert pts.dtype == np.float32 and cols.shape == pts.shape
    assert abs(len(pts) - len(jpts)) <= 0.06 * len(jpts)
    assert len(pts) > 1600  # tests/test_mvs.py: > 400 at stride 4
    assert (np.abs(pts[:, 2]) < 3.0).mean() > 0.9
    # gray frames: each point's color is 255 x its pixel's intensity
    assert (cols[:, 0] == cols[:, 1]).all() and (cols[:, 1] == cols[:, 2]).all()
    assert 0.0 <= cols.min() and cols.max() <= 255.0 and jcols.shape == jpts.shape
    assert sorted(dms) == [0, 1, 2] and N(dms[1].valid).sum() > 0
