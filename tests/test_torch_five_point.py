"""The port's Nister 5-point solver and the 5pt / "both" RANSAC against JAX.

Tolerances. ``real_roots_deg10`` on shared coefficients: roots rtol 1e-4,
valid masks identical. The polynomial stage fed JAX's own null-space basis:
valid slots identical, Es within 1e-4 after Frobenius and sign
normalization. The full solver takes its own basis (the 5x9 null basis is
not unique across LAPACK and XLA), so its solutions are compared as sets:
each valid E of one side equals a valid E of the other up to sign within
1e-4, and every one satisfies |x2^T E x1| < 1e-4 on the 5 points. RANSAC
5pt and "both" on JAX's injected samples: inlier counts within 1, pose
within 0.1 degree, on a general scene and on a ``render_plane_sequence``
pair. Scenes avoid near-double roots, where float32 noise decides whether
a candidate slot validates.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_parity import J, N, T, camera_scene, normalize, rotation_angle_deg

from sfm_mvs_tpu.ops import five_point as jfp
from sfm_mvs_tpu.ops import ransac as jr
from sfm_mvs_tpu.ops.epipolar import recover_pose as jrecover
from sfm_mvs_tpu_torch.ops import five_point, ransac
from sfm_mvs_tpu_torch.ops.epipolar import recover_pose

SEEDS = (0, 1, 2, 4, 5)
# The full solver's own basis gives another degree-10 polynomial: at seeds
# 3, 4, 10 and 11 a near-double root is found on one side only.
FULL_SEEDS = (0, 1, 2, 5, 6, 7, 8, 9)


def _pair(seed, n=20):
    """Normalized correspondences of a general (non-planar) two-view scene."""
    rng = np.random.default_rng(seed)
    aa = rng.normal(size=3) * 0.3
    th = np.linalg.norm(aa)
    k = aa / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = (np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    t /= np.linalg.norm(t)
    X = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(3, 6, size=n)
    X2 = X @ R.T + t
    return (X[:, :2] / X[:, 2:3]).astype(np.float32), (X2[:, :2] / X2[:, 2:3]).astype(np.float32)


@jax.jit
def _jax_basis(p1, p2):
    x1, y1, x2, y2 = p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1]
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, jnp.ones_like(x1)], -1)
    Vt = jnp.linalg.svd(A, full_matrices=True)[2]
    return [Vt[k].reshape(3, 3) for k in (5, 6, 7, 8)]


_jax_solver = jax.jit(jfp.essential_five_point)


def _normalized(Es):
    """Frobenius-normalized, sign fixed by the largest-magnitude entry."""
    E = Es / np.linalg.norm(Es, axis=(-2, -1), keepdims=True)
    flat = E.reshape(len(E), -1)
    sign = np.sign(flat[np.arange(len(E)), np.abs(flat).argmax(1)])
    return E * sign[:, None, None]


def test_real_roots_deg10():
    true = np.array([-7.5, -2.0, -0.3, 0.6, 1.0, 4.0])
    rng = np.random.default_rng(0)
    polys = [np.poly(np.concatenate([true, [1j, -1j, 2j, -2j]])).real]
    for _ in range(5):  # random real roots, inside and outside |z| < 1
        r = np.sort(rng.uniform(-5, 5, 4)) * rng.choice([0.1, 1.0, 10.0], 4)
        c = rng.normal(size=3)
        polys.append(np.poly(np.concatenate([r, c + 1j, c - 1j])).real)
    coeffs = np.stack(polys).astype(np.float32)
    ref = jax.jit(jax.vmap(jfp.real_roots_deg10))(J(coeffs))
    roots, valid = five_point.real_roots_deg10(T(coeffs))
    np.testing.assert_array_equal(N(valid), N(ref[1]))
    assert N(valid)[0].sum() == 6
    v = N(valid)
    np.testing.assert_allclose(N(roots)[v], N(ref[0])[v], rtol=1e-4, atol=1e-6)
    found = np.sort(N(roots)[0][v[0]])
    np.testing.assert_allclose(found, true, atol=2e-4)


@pytest.mark.parametrize("seed", SEEDS)
def test_polynomial_stage_on_jax_basis(seed):
    x1, x2 = _pair(seed)
    p1, p2 = J(x1[:5]), J(x2[:5])
    Ej, vj = (N(a) for a in _jax_solver(p1, p2))
    basis = [T(b)[None] for b in _jax_basis(p1, p2)]
    Et, vt = five_point.essential_from_basis(*basis)
    Et, vt = N(Et)[0], N(vt)[0]
    np.testing.assert_array_equal(vt, vj)
    assert vt.sum() >= 1
    np.testing.assert_allclose(_normalized(Et[vt]), _normalized(Ej[vj]), atol=1e-4)


def test_full_solver_solution_sets():
    xs = [_pair(s) for s in FULL_SEEDS]
    p1 = np.stack([x[0][:5] for x in xs])
    p2 = np.stack([x[1][:5] for x in xs])
    Es, valid = five_point.essential_five_point(T(p1), T(p2))  # batched over the seeds
    assert Es.shape == (len(FULL_SEEDS), five_point.N_ROOT_SLOTS, 3, 3)
    for k, (x1, x2) in enumerate(xs):
        Ej, vj = (N(a) for a in _jax_solver(J(x1[:5]), J(x2[:5])))
        ours = _normalized(N(Es)[k][N(valid)[k]])
        ref = _normalized(Ej[vj])
        assert len(ours) >= 1
        # Each solution of one side is a solution of the other, up to sign.
        for a, b in ((ours, ref), (ref, ours)):
            d = np.abs(a[:, None] - b[None]).max(axis=(-2, -1))
            assert d.min(axis=1).max() < 1e-4
        h1 = np.concatenate([x1[:5], np.ones((5, 1))], 1)
        h2 = np.concatenate([x2[:5], np.ones((5, 1))], 1)
        assert np.abs(np.einsum("ni,kij,nj->kn", h2, ours, h1)).max() < 1e-4


def _scenes():
    rng = np.random.default_rng(0)
    s = camera_scene(rng, n=160, noise_px=0.3, outlier_frac=0.3)
    general = (normalize(s["uv0"], s["K"]), normalize(s["uv1"], s["K"]), s["R"],
               rng.random(160) < 0.9)
    from sfm_mvs_tpu_torch.utils.synthetic import render_plane_sequence

    _, Rt, K = render_plane_sequence(num_cameras=2, arc_degrees=15, image_size=(320, 240))
    X = np.c_[rng.uniform(-1.8, 1.8, (200, 2)), np.zeros(200)].astype(np.float32)
    uv = [(X @ Rt[c][:, :3].T + Rt[c][:, 3]) for c in range(2)]
    uv = [(u[:, :2] / u[:, 2:]).astype(np.float32) for u in uv]
    uv[1][150:] += rng.uniform(-0.05, 0.05, (50, 2)).astype(np.float32)  # outliers
    R_rel = Rt[1][:, :3] @ Rt[0][:, :3].T
    return {"general": general, "plane": (uv[0], uv[1], R_rel.astype(np.float32),
                                          np.ones(200, bool))}


SCENES = _scenes()


@pytest.mark.parametrize("solver", ["5pt", "both"])
@pytest.mark.parametrize("scene", ["general", "plane"])
def test_ransac_essential_families(solver, scene):
    n0, n1, R_true, mask = SCENES[scene]
    key = jax.random.PRNGKey(7)
    iters = 64
    focal = np.float32(500.0)
    ref = jr.ransac_essential(key, J(n0), J(n1), J(mask), jnp.float32(focal), threshold_px=2.0,
                              iters=iters, solver=solver)
    k1, k2 = jax.random.split(key)
    count = jnp.sum(J(mask))
    if solver == "5pt":
        idx8, idx5 = None, T(jr._sample_indices(k1, iters, 5, count, len(n0)))
    else:
        idx8 = T(jr._sample_indices(k1, iters, 8, count, len(n0)))
        idx5 = T(jr._sample_indices(k2, iters // 4, 5, count, len(n0)))
    ours = ransac.ransac_essential(None, T(n0), T(n1), T(mask), T(focal), threshold_px=2.0,
                                   iters=iters, solver=solver, sample_idx=idx8,
                                   sample_idx5=idx5)
    assert abs(int(ours.num_inliers) - int(ref.num_inliers)) <= 1
    assert int(ours.num_inliers) > 0.6 * mask.sum() * (0.7 if scene == "general" else 0.75)
    R, _, _ = recover_pose(ours.model, T(n0), T(n1), ours.inliers)
    Rj, _, _ = jrecover(ref.model, J(n0), J(n1), ref.inliers)
    assert rotation_angle_deg(N(R), N(Rj)) < 0.1
    if scene == "general":
        assert rotation_angle_deg(N(R), R_true) < 1.0


def test_ransac_essential_draws_from_generator():
    """Without injected samples the port draws its own (8pt, then 5pt)."""
    import torch

    n0, n1, R_true, mask = SCENES["general"]
    gen = torch.Generator().manual_seed(0)
    res = ransac.ransac_essential(gen, T(n0), T(n1), T(mask), T(np.float32(500.0)),
                                  threshold_px=2.0, iters=64, solver="both")
    R, _, _ = recover_pose(res.model, T(n0), T(n1), res.inliers)
    assert int(res.num_inliers) > 80 and rotation_angle_deg(N(R), R_true) < 2.0
    with pytest.raises(ValueError, match="solver"):
        ransac.ransac_essential(gen, T(n0), T(n1), T(mask), T(np.float32(500.0)),
                                solver="7pt")
