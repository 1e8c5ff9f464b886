"""BA of the intrinsics in the port against the JAX package.

The problem of tests/test_ba_intrinsics.py: 6 cameras, 256 points,
K = (400, 400, 160, 120), observations rendered with the intrinsics
[s, k1, k2] = [1.02, -0.08, 0.02] plus 0.3 px noise; the cameras start
0.01 off and the points 0.02 off.

Tolerances. Residuals and the closed-form Jacobians (the shared block T,
the 2x9 per-camera block, and the camera and point blocks through the
distortion) against the JAX package's ``jax.jacfwd`` grids: rtol 1e-4,
atol 1e-5 of each block's largest entry. One ``_lm_solve`` step (20 CG
steps on a system whose focal scale trades against depth): rtol 1e-3, atol
1e-3 of the largest entry, as the 6-dof step's margin; 2e-3 for the shared
intrinsics step, whose k2 is nearly collinear with k1 and s at this field
of view (tests/test_distortion.py). ``run_ba(refine_intrinsics=True)`` and
the 9-wide solve: the port's cost of JAX's iterate after each of the first 3 iterations rtol
1e-5, the port's own trajectory rtol 1e-3 with equal counters, the final
cost after 10 iterations rtol 1e-3. The K fold and the per-camera variant
on tests/test_ba.py's map: K equals JAX's within rtol 1e-3 and is the input
K times s exactly; camera 0's per-camera intrinsics are exactly
[1, 0, 0].
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import N, ba_map, jax_and_port

from sfm_mvs_tpu.models import ba as jba
from sfm_mvs_tpu_torch.models import ba
from sfm_mvs_tpu_torch.utils import convert

INTR = (1.02, -0.08, 0.02)
CG = 30


def _problem(width):
    rng = np.random.default_rng(0)
    C, P = 6, 256
    K = jnp.asarray([[400.0, 0.0, 160.0], [0.0, 400.0, 120.0], [0.0, 0.0, 1.0]], jnp.float32)
    pts = jnp.asarray(rng.uniform([-2.5, -2.0, 4.0], [2.5, 2.0, 8.0], size=(P, 3)), jnp.float32)
    cams = jnp.asarray(np.stack([np.r_[0.0, 0.04 * i, 0.0, -0.6 * i, 0.1 * (i % 2), 0.0]
                                 for i in range(C)]), jnp.float32)
    obs = jba._res_grid(cams, pts, jnp.zeros((P, C, 2), jnp.float32), K,
                        jnp.asarray(INTR, jnp.float32))
    obs = obs + 0.3 * rng.standard_normal(obs.shape).astype(np.float32)
    cams = cams + jnp.asarray(rng.normal(scale=0.01, size=cams.shape), jnp.float32)
    if width == 9:
        cams = jnp.concatenate([cams, jnp.asarray(rng.normal(scale=0.02, size=(C, 3)),
                                                  jnp.float32)], -1)
    jp = jba.BAProblem(cam_params=cams, points=pts + 0.02, cam_valid=jnp.ones((C,), bool),
                       point_valid=jnp.ones((P,), bool), obs_uv=obs,
                       obs_mask=jnp.ones((P, C), bool), K=K, frozen=jnp.arange(C) < 1,
                       intr=jnp.asarray(INTR if width == 6 else jba._INTR_IDENTITY, jnp.float32))
    return jp, convert.to_torch(type(jp)(*[np.asarray(a) for a in jp]))


def _close_blocks(ours, ref, rtol=1e-4, atol=1e-5):
    """Per (p, c) cell, against the block's largest entry."""
    ours, ref = N(ours), N(ref)
    scale = np.maximum(np.abs(ref).max(axis=(-2, -1), keepdims=True), 1.0)
    assert (np.abs(ours - ref) <= atol * scale + rtol * np.abs(ref)).all()


@pytest.mark.parametrize("width", [6, 9])
def test_residuals_and_jacobians(width):
    jp, tp = _problem(width)
    args = (jp.cam_params, jp.points, jp.obs_uv, jp.K, jp.intr)
    targs = (tp.cam_params, tp.points, tp.obs_uv, tp.K, tp.intr)
    if width == 6:
        r, (A, B, Tj) = jax.jit(jba._res_jac_grid_intr)(*args)
        rt, At, Bt, Tt = ba._res_jac_grid(*targs, intr_jacobian=True)
        _close_blocks(Tt, Tj)
    else:
        r, (A, B) = jax.jit(jba._res_jac_grid9)(*args)
        rt, At, Bt = ba._res_jac_grid(*targs)
        assert At.shape[-1] == 9
    np.testing.assert_allclose(N(rt), N(r), atol=1e-3)
    np.testing.assert_array_equal(N(ba._res_grid(*targs)), N(rt))
    _close_blocks(At, A)
    _close_blocks(Bt, B)


def test_identity_intrinsics_are_the_pinhole():
    """At [1, 0, 0] the distortion terms vanish exactly: the same residuals
    and Jacobians as without intrinsics, and a zero T for k1, k2 at the
    image centre's ray."""
    _, tp = _problem(6)
    ident = torch.tensor(ba._INTR_IDENTITY)
    r0, A0, B0 = ba._res_jac_grid(tp.cam_params, tp.points, tp.obs_uv, tp.K)
    r1, A1, B1, T1 = ba._res_jac_grid(tp.cam_params, tp.points, tp.obs_uv, tp.K, ident,
                                      intr_jacobian=True)
    for a, b in ((r0, r1), (A0, A1), (B0, B1)):
        np.testing.assert_array_equal(N(a), N(b))
    assert torch.isfinite(T1).all()


@pytest.mark.parametrize("width", [6, 9])
def test_lm_solve_step(width):
    jp, tp = _problem(width)
    refine = width == 6
    solve = jax.jit(jba._lm_solve, static_argnames=("cg_iters", "refine_intrinsics"))
    dc, dp, dt = solve(jp, jnp.float32(1e-3), cg_iters=20, refine_intrinsics=refine)
    tdc, tdp, tdt = ba._lm_solve(tp, torch.tensor(1e-3), 20, refine_intrinsics=refine)
    assert np.abs(N(dc)).max() > 1e-3
    for ours, ref, margin in ((tdc, dc, 1e-3), (tdp, dp, 1e-3), (tdt, dt, 2e-3)):
        ref = N(ref)
        np.testing.assert_allclose(N(ours), ref, rtol=1e-3, atol=margin * np.abs(ref).max())
    np.testing.assert_array_equal(N(tdc)[0], 0.0)  # the frozen gauge camera, intrinsics too
    if refine:
        assert np.abs(N(tdt)).max() > 1e-4


@pytest.mark.parametrize("width", [6, 9])
def test_run_ba_trajectory(width):
    jp, tp = _problem(width)
    refine = width == 6
    for it in (1, 2, 3):
        jout, jst = jba.run_ba(jp, max_iterations=it, cg_iters=CG, refine_intrinsics=refine)
        jout_t = convert.to_torch(type(jout)(*[np.asarray(a) for a in jout]))
        np.testing.assert_allclose(float(ba._cost(jout_t)), float(jst.final_cost), rtol=1e-5)
        out, st = ba.run_ba(tp, max_iterations=it, cg_iters=CG, refine_intrinsics=refine)
        np.testing.assert_allclose(float(st.final_cost), float(jst.final_cost), rtol=1e-3)
        assert [int(st.iterations), int(st.accepted)] == [int(jst.iterations), int(jst.accepted)]
        np.testing.assert_allclose(N(out.intr), N(jout.intr), rtol=1e-4)
    jout, jst = jba.run_ba(jp, max_iterations=10, cg_iters=CG, refine_intrinsics=refine)
    out, st = ba.run_ba(tp, max_iterations=10, cg_iters=CG, refine_intrinsics=refine)
    np.testing.assert_allclose(float(st.initial_cost), float(jst.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(st.final_cost), float(jst.final_cost), rtol=1e-3)
    assert float(st.final_cost) < 0.01 * float(st.initial_cost)
    if not refine:  # the 9-wide solve leaves the shared block alone
        np.testing.assert_array_equal(N(out.intr), N(tp.intr))


def test_intrinsics_entry_points():
    js, ts = jax_and_port(ba_map(obs_noise=0.3))
    jout, jst, jintr = jba.bundle_adjust_map_intrinsics(js, max_iterations=5, cg_iters=CG)
    out, st, intr = ba.bundle_adjust_map_intrinsics(ts, max_iterations=5, cg_iters=CG)
    np.testing.assert_allclose(float(st.final_cost), float(jst.final_cost), rtol=1e-3)
    np.testing.assert_allclose(N(out.K), N(jout.K), rtol=1e-3)
    K_in, s = N(ts.K), float(intr[0])
    np.testing.assert_array_equal(N(out.K)[[0, 0, 1], [0, 1, 1]],
                                  (K_in[[0, 0, 1], [0, 1, 1]] * np.float32(s)).astype(np.float32))
    np.testing.assert_array_equal(N(out.K)[[0, 1, 2], [2, 2, 2]], K_in[[0, 1, 2], [2, 2, 2]])

    jout, jst, jpc = jba.bundle_adjust_map_percam_intrinsics(js, max_iterations=5, cg_iters=CG)
    out, st, pc = ba.bundle_adjust_map_percam_intrinsics(ts, max_iterations=5, cg_iters=CG)
    assert pc.shape == (8, 3) and torch.isfinite(pc).all()
    np.testing.assert_array_equal(N(pc)[0], [1.0, 0.0, 0.0])
    assert float(st.final_cost) <= float(st.initial_cost)
    np.testing.assert_allclose(float(st.final_cost), float(jst.final_cost), rtol=1e-3)
    np.testing.assert_allclose(N(pc)[:5], N(jpc)[:5], atol=2e-3)
