"""RANSAC parity: the port scores the JAX package's own hypotheses.

The JAX package draws minimal samples with ``jax.random``; the port with a
``torch.Generator``. To compare like with like, each test repeats the JAX
estimator's internal key splits, builds its ``_sample_indices`` output, and
injects those indices into the port. The winning inlier mask must then be
identical, and the model must agree within 1e-4 (E up to sign: SVD null
vectors have no preferred sign).
"""

import numpy as np

import jax
import jax.numpy as jnp

from _torch_parity import J, N, T, assert_close, camera_scene, normalize, rotation_angle_deg

from sfm_mvs_tpu.ops import ransac as jr
from sfm_mvs_tpu_torch.ops import ransac


def _mask(rng, n):
    return rng.random(n) < 0.9


def test_ransac_essential_8pt(rng):
    s = camera_scene(rng, n=160, noise_px=0.3, outlier_frac=0.3)
    n0, n1 = normalize(s["uv0"], s["K"]), normalize(s["uv1"], s["K"])
    mask = _mask(rng, len(n0))
    key = jax.random.PRNGKey(7)
    iters = 128
    ref = jr.ransac_essential(key, J(n0), J(n1), J(mask), jnp.float32(500.0),
                              threshold_px=2.0, iters=iters)
    k1, _ = jax.random.split(key)
    idx = jr._sample_indices(k1, iters, 8, jnp.sum(J(mask)), len(n0))
    ours = ransac.ransac_essential(None, T(n0), T(n1), T(mask), T(np.float32(500.0)),
                                   threshold_px=2.0, iters=iters, sample_idx=T(idx))
    np.testing.assert_array_equal(N(ours.inliers), N(ref.inliers))
    assert int(ours.num_inliers) == int(ref.num_inliers) > 80
    E, Ej = N(ours.model), N(ref.model)
    np.testing.assert_allclose(E * np.sign(np.sum(E * Ej)), Ej, atol=1e-4)


def test_ransac_pnp_with_p3p(rng):
    s = camera_scene(rng, n=200, noise_px=0.3, outlier_frac=0.3)
    K, X, uv = s["K"], s["X"], s["uv1"]
    uvn = normalize(uv, K)
    mask = _mask(rng, len(X))
    key = jax.random.PRNGKey(3)
    iters = 256
    ref = jr.ransac_pnp(key, J(X), J(uv), J(uvn), J(mask), J(K), iters=iters)
    k1, k2 = jax.random.split(key)
    count = jnp.sum(J(mask))
    idx6 = jr._sample_indices(k1, iters, 6, count, len(X))
    idx3 = jr._sample_indices(k2, iters // 4, 3, count, len(X))
    ours = ransac.ransac_pnp(None, T(X), T(uv), T(uvn), T(mask), T(K), iters=iters,
                             sample_idx=T(idx6), sample_idx3=T(idx3))
    np.testing.assert_array_equal(N(ours.inliers), N(ref.inliers))
    assert int(ours.num_inliers) == int(ref.num_inliers) > 100
    assert_close(ours.model, ref.model, rtol=0, atol=1e-4)
    assert rotation_angle_deg(N(ours.model)[:, :3], s["R"]) < 0.2


def test_ransac_homography(rng):
    s = camera_scene(rng, n=160, noise_px=0.3, outlier_frac=0.3, planar=True)
    p0, p1 = s["uv0"], s["uv1"]
    mask = _mask(rng, len(p0))
    key = jax.random.PRNGKey(11)
    iters = 128
    ref = jr.ransac_homography(key, J(p0), J(p1), J(mask), threshold_px=4.0, iters=iters)
    k1, _ = jax.random.split(key)
    idx = jr._sample_indices(k1, iters, 4, jnp.sum(J(mask)), len(p0))
    ours = ransac.ransac_homography(None, T(p0), T(p1), T(mask), threshold_px=4.0,
                                    iters=iters, sample_idx=T(idx))
    np.testing.assert_array_equal(N(ours.inliers), N(ref.inliers))
    assert int(ours.num_inliers) == int(ref.num_inliers) > 80
    assert_close(ours.model, ref.model, rtol=1e-4, atol=1e-4)
