"""Parity of the port's leaf and two-view/PnP geometry with the JAX package.

Same numpy inputs through both packages. Tolerance: rtol 1e-4 / atol 1e-5
in float32 (the two differ only in operation order and in their LAPACK
calls). SVD-derived quantities are compared up to sign, or through their
outcome (residuals, or the chosen pose's rotation error).
"""

import numpy as np
import pytest

from _torch_parity import J, N, T, assert_close, camera_scene, normalize, rotation_angle_deg

from sfm_mvs_tpu.ops import epipolar as jepi
from sfm_mvs_tpu.ops import homography as jhom
from sfm_mvs_tpu.ops import lie as jlie
from sfm_mvs_tpu.ops import linalg as jlin
from sfm_mvs_tpu.ops import masking as jmask
from sfm_mvs_tpu.ops import p3p as jp3p
from sfm_mvs_tpu.ops import pnp as jpnp
from sfm_mvs_tpu.ops import projection as jproj
from sfm_mvs_tpu.ops import triangulation as jtri
from sfm_mvs_tpu_torch.ops import epipolar, homography, lie, linalg, masking, p3p, pnp
from sfm_mvs_tpu_torch.ops import projection, triangulation


def _rotation_about(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis /= np.linalg.norm(axis)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx).astype(np.float32)


def test_so3_exp_log_hat_vee(rng):
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w[:4] *= 1e-5  # Taylor branch
    assert_close(lie.so3_exp(T(w)), jlie.so3_exp(J(w)))
    R = N(jlie.so3_exp(J(w)))
    assert_close(lie.so3_log(T(R)), jlie.so3_log(J(R)))
    assert_close(lie.vee(lie.hat(T(w))), w)


@pytest.mark.parametrize("angle", [np.pi - 1e-4, np.pi, np.pi - 5e-3])
def test_so3_log_near_pi(rng, angle):
    """The theta ~ pi branch (symmetric-part axis) agrees with the JAX
    package (up to the +/- axis ambiguity at pi) and round-trips through exp
    within the branch's own accuracy (~0.2 deg at pi - 5e-3 in both)."""
    Rs = np.stack([_rotation_about(rng.normal(size=3), angle) for _ in range(8)])
    ours = N(lie.so3_log(T(Rs)))
    ref = N(jlie.so3_log(J(Rs)))
    sign = np.sign(np.sum(ours * ref, axis=-1, keepdims=True))
    np.testing.assert_allclose(ours * sign, ref, rtol=1e-4, atol=1e-3)
    back = N(lie.so3_exp(T(ours)))
    for a, b in zip(back, Rs):
        assert rotation_angle_deg(a, b) < 0.5


def test_orthonormalize_and_rt(rng):
    R = N(jlie.so3_exp(J(rng.normal(size=(16, 3)).astype(np.float32))))
    noisy = R + 0.01 * rng.normal(size=R.shape).astype(np.float32)
    assert_close(lie.orthonormalize(T(noisy)), jlie.orthonormalize(J(noisy)))
    tv = rng.normal(size=(16, 3)).astype(np.float32)
    rv = rng.normal(size=(16, 3)).astype(np.float32)
    assert_close(lie.rt_to_matrix(T(rv), T(tv)), jlie.rt_to_matrix(J(rv), J(tv)))


def test_smallest_eigvec(rng):
    A = rng.normal(size=(32, 11, 12)).astype(np.float32)  # rank 11: null vector
    G = np.einsum("bij,bik->bjk", A, A)
    ours = N(linalg.smallest_eigvec(T(G)))
    ref = N(jlin.smallest_eigvec(J(G)))
    sign = np.sign(np.sum(ours * ref, axis=-1, keepdims=True))
    np.testing.assert_allclose(ours * sign, ref, rtol=1e-4, atol=1e-4)
    assert np.abs(np.einsum("bij,bj->bi", A, ours)).max() < 1e-3


def test_projection_functions(rng):
    s = camera_scene(rng, outlier_frac=0.0)
    K, X = s["K"], s["X"]
    Rt = np.concatenate([s["R"], s["t"][:, None]], axis=1)
    assert_close(projection.project(T(X), T(Rt), T(K)), jproj.project(J(X), J(Rt), J(K)))
    dist = np.array([-0.05, 0.01], np.float32)
    assert_close(projection.project(T(X), T(Rt), T(K), T(dist)),
                 jproj.project(J(X), J(Rt), J(K), J(dist)))
    assert_close(projection.undistort_pixels(T(s["uv1"]), T(K), T(dist)),
                 jproj.undistort_pixels(J(s["uv1"]), J(K), J(dist)))
    uv, d = projection.project_depth(T(X), T(Rt), T(K))
    uvj, dj = jproj.project_depth(J(X), J(Rt), J(K))
    assert_close(uv, uvj)
    assert_close(d, dj)
    assert_close(projection.normalize_points(T(s["uv1"]), T(K)),
                 jproj.normalize_points(J(s["uv1"]), J(K)))
    mask = rng.random(len(X)) < 0.7
    for fn, jfn in [(projection.masked_mean_reprojection_error, jproj.masked_mean_reprojection_error),
                    (projection.masked_rms_reprojection_error, jproj.masked_rms_reprojection_error)]:
        assert_close(fn(T(X), T(s["uv1"]), T(Rt), T(K), T(mask)),
                     jfn(J(X), J(s["uv1"]), J(Rt), J(K), J(mask)))
    pn, Tm = projection.hartley_normalization(T(s["uv0"]), T(mask))
    pnj, Tmj = jproj.hartley_normalization(J(s["uv0"]), J(mask))
    assert_close(pn, pnj)
    assert_close(Tm, Tmj)


def test_compact_keeps_stable_order(rng):
    mask = rng.random(300) < 0.4
    vals = rng.normal(size=(300, 2)).astype(np.float32)
    ours = masking.compact(T(mask), T(vals))
    ref = jmask.compact(J(mask), J(vals))
    assert int(ours[0]) == int(ref[0])
    np.testing.assert_array_equal(N(ours[1]), N(ref[1]))
    np.testing.assert_array_equal(N(ours[2]), N(ref[2]))
    np.testing.assert_array_equal(N(masking.compact_order(T(mask))), N(jmask.compact_order(J(mask))))


def test_triangulation(rng):
    s = camera_scene(rng, outlier_frac=0.0, noise_px=0.0)
    K = s["K"]
    P0 = K @ np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1).astype(np.float32)
    P1 = (K @ np.concatenate([s["R"], s["t"][:, None]], axis=1)).astype(np.float32)
    ours = triangulation.triangulate_points(T(P0), T(P1), T(s["uv0"]), T(s["uv1"]))
    ref = jtri.triangulate_points(J(P0), J(P1), J(s["uv0"]), J(s["uv1"]))
    assert_close(ours, ref, atol=1e-4)
    assert_close(ours[:, :3], s["X"], atol=1e-2)
    Rt1 = np.concatenate([s["R"], s["t"][:, None]], axis=1)
    Rt0 = np.eye(3, 4, dtype=np.float32)
    d = triangulation.triangulation_depths(T(Rt0), T(Rt1), ours[:, :3])
    dj = jtri.triangulation_depths(J(Rt0), J(Rt1), J(N(ours[:, :3])))
    assert_close(d[0], dj[0])
    assert_close(d[1], dj[1])


@pytest.mark.parametrize("method", ["svd", "eigh", "inviter"])
def test_homography_dlt(rng, method):
    H0 = np.array([[1.1, 0.05, 12.0], [-0.03, 0.95, -7.0], [1e-4, -2e-4, 1.0]], np.float32)
    p1 = rng.uniform(0, 600, (40, 2)).astype(np.float32)
    h = np.concatenate([p1, np.ones((40, 1), np.float32)], 1) @ H0.T
    p2 = (h[:, :2] / h[:, 2:]).astype(np.float32)
    w = (rng.random(40) < 0.8).astype(np.float32)
    ours = homography.homography_dlt(T(p1), T(p2), T(w), method=method)
    ref = jhom.homography_dlt(J(p1), J(p2), J(w), method=method)
    assert_close(ours, ref, rtol=1e-3, atol=1e-4)
    assert_close(homography.transfer_error(ours, T(p1), T(p2)),
                 jhom.transfer_error(ref, J(p1), J(p2)), atol=1e-3)
    batch = homography.homography_dlt(T(p1).expand(3, 40, 2), T(p2).expand(3, 40, 2),
                                      method=method)
    assert_close(batch[1], homography.homography_dlt(T(p1), T(p2), method=method))


def test_essential_and_recover_pose(rng):
    s = camera_scene(rng, outlier_frac=0.0, noise_px=0.0)
    n0, n1 = normalize(s["uv0"], s["K"]), normalize(s["uv1"], s["K"])
    # The unconditioned 8-point design matrix is ill-conditioned in float32:
    # the two LAPACK SVDs return null vectors ~1e-3 apart. Compare the
    # outcome instead — both E explain the data to a small fraction of a
    # pixel — and then run pose recovery from the same E.
    for method in ("svd", "eigh"):
        E = epipolar.essential_eight_point(T(n0), T(n1), method=method)
        Ej = jepi.essential_eight_point(J(n0), J(n1), method=method)
        ours = N(epipolar.epipolar_residual_pixels(E, T(n0), T(n1), 500.0))
        ref = N(jepi.epipolar_residual_pixels(Ej, J(n0), J(n1), 500.0))
        tol = 0.05 if method == "svd" else 1.5  # eigh squares the condition number
        assert ours.max() < tol and ref.max() < tol
        np.testing.assert_allclose(N(E) @ N(E).T, N(Ej) @ N(Ej).T, atol=2e-2)
    E = N(jepi.essential_eight_point(J(n0), J(n1)))
    assert_close(epipolar.sampson_error(T(E), T(n0), T(n1)),
                 jepi.sampson_error(J(E), J(n0), J(n1)), atol=1e-9)
    mask = np.ones(len(n0), bool)
    R, t, good = epipolar.recover_pose(T(E), T(n0), T(n1), T(mask))
    Rj, tj, goodj = jepi.recover_pose(J(E), J(n0), J(n1), J(mask))
    assert rotation_angle_deg(R, Rj) < 1e-3
    assert_close(t, tj, atol=1e-4)
    np.testing.assert_array_equal(N(good), N(goodj))
    assert rotation_angle_deg(R, s["R"]) < 0.2

    R2, t2 = epipolar.refine_relative_pose(R, t, T(n0), T(n1), T(mask))
    R2j, t2j = jepi.refine_relative_pose(Rj, tj, J(n0), J(n1), J(mask))
    assert rotation_angle_deg(R2, R2j) < 1e-3
    assert_close(t2, t2j, atol=1e-4)


def test_homography_pose_decomposition(rng):
    s = camera_scene(rng, outlier_frac=0.0, noise_px=0.0, planar=True)
    n0, n1 = normalize(s["uv0"], s["K"]), normalize(s["uv1"], s["K"])
    Hn = N(jhom.homography_dlt(J(n0), J(n1)))
    Rs, ts, ns = epipolar.decompose_homography(T(Hn))
    Rsj, tsj, nsj = jepi.decompose_homography(J(Hn))
    # The SVD's sign choices may order the four candidates differently:
    # compare them as sets.
    for k in range(4):
        j = min(range(4), key=lambda i: rotation_angle_deg(Rs[k], Rsj[i])
                + float(np.abs(N(ts[k]) - N(tsj[i])).sum()))
        assert rotation_angle_deg(Rs[k], Rsj[j]) < 1e-3
        assert_close(ts[k], tsj[j], atol=1e-4)
        assert_close(ns[k], nsj[j], atol=1e-4)
    mask = np.ones(len(n0), bool)
    R, t, good = epipolar.recover_pose_from_homography(T(Hn), T(n0), T(n1), T(mask))
    Rj, tj, goodj = jepi.recover_pose_from_homography(J(Hn), J(n0), J(n1), J(mask))
    assert rotation_angle_deg(R, Rj) < 1e-3
    assert_close(t, tj, atol=1e-4)
    np.testing.assert_array_equal(N(good), N(goodj))


def _pnp_sample(rng, n, planar=False):
    s = camera_scene(rng, n=n, outlier_frac=0.0, noise_px=0.0, planar=planar)
    return s, normalize(s["uv1"], s["K"])


# eigh takes the null vector of A^T A, squaring the design matrix's
# condition number: the two LAPACKs then agree to ~1e-2 deg, not 1e-3.
@pytest.mark.parametrize("method,tol_deg", [("svd", 1e-3), ("eigh", 1e-2), ("inviter", 1e-3)])
def test_pnp_dlt_and_planar(rng, method, tol_deg):
    s, uvn = _pnp_sample(rng, 12)
    Rt = pnp.pnp_dlt(T(s["X"]), T(uvn), method=method)
    Rtj = jpnp.pnp_dlt(J(s["X"]), J(uvn), method=method)
    assert rotation_angle_deg(N(Rt)[:, :3], N(Rtj)[:, :3]) < tol_deg
    assert_close(N(Rt)[:, 3], N(Rtj)[:, 3], atol=1e-3)
    s, uvn = _pnp_sample(rng, 12, planar=True)
    Rt = pnp.pnp_planar(T(s["X"]), T(uvn), method=method)
    Rtj = jpnp.pnp_planar(J(s["X"]), J(uvn), method=method)
    assert rotation_angle_deg(N(Rt)[:, :3], N(Rtj)[:, :3]) < tol_deg
    assert_close(N(Rt)[:, 3], N(Rtj)[:, 3], atol=1e-3)
    assert rotation_angle_deg(N(Rt)[:, :3], s["R"]) < 1e-2


def test_pnp_refine_and_residuals(rng):
    s = camera_scene(rng, outlier_frac=0.2, noise_px=0.3)
    Rt_true = np.concatenate([s["R"], s["t"][:, None]], axis=1)
    Rt0 = N(jlie.rt_to_matrix(jlie.so3_log(J(s["R"])) + 0.01, J(s["t"] + 0.05)))
    mask = s["inlier"]
    ours = pnp.refine_pose_gauss_newton(T(Rt0), T(s["X"]), T(s["uv1"]), T(mask), T(s["K"]))
    ref = jpnp.refine_pose_gauss_newton(J(Rt0), J(s["X"]), J(s["uv1"]), J(mask), J(s["K"]))
    assert rotation_angle_deg(N(ours)[:, :3], N(ref)[:, :3]) < 1e-3
    assert_close(N(ours)[:, 3], N(ref)[:, 3], atol=1e-4)
    assert rotation_angle_deg(N(ours)[:, :3], Rt_true[:, :3]) < 0.05
    assert_close(pnp.pnp_residual_pixels(ours, T(s["X"]), T(s["uv1"]), T(s["K"])),
                 jpnp.pnp_residual_pixels(J(N(ours)), J(s["X"]), J(s["uv1"]), J(s["K"])),
                 atol=1e-3)


def test_p3p_grunert(rng):
    """Valid-slot counts agree within one (a near-double root can fall on
    either side of the validity test), and the slot that recovers the true
    pose does so in both packages, to the same pose."""
    import jax

    s, uvn = _pnp_sample(rng, 3 * 16)
    X = s["X"].reshape(16, 3, 3)
    uv = uvn.reshape(16, 3, 2)
    Rts, valid = (N(a) for a in p3p.p3p_grunert(T(X), T(uv)))
    Rtj, vj = (N(a) for a in jax.jit(jax.vmap(jp3p.p3p_grunert))(J(X), J(uv)))
    for i in range(16):
        assert abs(int(valid[i].sum()) - int(vj[i].sum())) <= 1

        def best(rts, v):
            ks = np.nonzero(v)[0]
            errs = [rotation_angle_deg(rts[k, :, :3], s["R"]) for k in ks]
            return ks[int(np.argmin(errs))], min(errs)

        k, err = best(Rts[i], valid[i])
        kj, errj = best(Rtj[i], vj[i])
        assert err < 0.05 and errj < 0.05
        assert rotation_angle_deg(Rts[i, k, :, :3], Rtj[i, kj, :, :3]) < 1e-2
        np.testing.assert_allclose(Rts[i, k, :, 3], Rtj[i, kj, :, 3], atol=1e-3)


def test_pose_jacobian_closed_form_matches_autodiff(rng):
    """The PnP polish's closed-form Jacobian equals forward-mode AD of its
    residuals, at a generic rotation and near zero (Taylor branch)."""
    s = camera_scene(rng, n=40, outlier_frac=0.0)
    m = T((rng.random(40) < 0.8).astype(np.float32))
    X, uv, K = T(s["X"]), T(s["uv1"]), T(s["K"])
    for w in (np.array([0.2, -0.4, 0.1]), np.array([1e-5, 0.0, -2e-5])):
        params = T(np.concatenate([w, s["t"]]).astype(np.float32))
        r, Jc = pnp._pose_residuals_and_jacobian(params, X, uv, m, K)

        def residuals(p):
            pose = lie.rt_to_matrix(p[:3], p[3:])
            return ((projection.project(X, pose, K) - uv) * m[:, None]).reshape(-1)

        assert_close(r, residuals(params), atol=1e-4)
        assert_close(Jc, linalg.jacobian(residuals, params), rtol=1e-3, atol=1e-2)
