"""Bundle adjustment (models/ba.py) against the JAX package.

Scene as in tests/test_ba.py: 5 cameras over a 50-degree arc, 300 points,
MapConfig(8, 512); points perturbed by 0.05, camera 1-4 poses by 0.02 rad
and 0.06, observations exact or with 0.3 px noise. The same numpy map goes
to both packages (utils/convert.py).

Tolerances: residuals 1e-3 px and Jacobian entries 1e-4 of their 2x6 / 2x3
block's largest entry (float32 rounding of terms ~1e3 px); costs rtol 1e-5
(a sum over the grid in another order); one Schur + PCG solve rtol 1e-3,
atol 1e-5. Full solves: the same LM trajectory, so the iteration and
acceptance counters are equal while every step is a clear decision (on
noiseless data that holds for 8 iterations; past that the cost sits at the
float32 floor, ~1e-9 px^2, and accept/reject is rounding).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import J, N, T, ba_map, jax_and_port, rotation_angle_deg

from sfm_mvs_tpu.models import ba as jba
from sfm_mvs_tpu_torch.models import ba
from sfm_mvs_tpu_torch.ops import lie
from sfm_mvs_tpu_torch.utils import convert

ITERS, CG = 8, 30  # one JAX run_ba compile serves every 8-iteration solve


@pytest.fixture(scope="module")
def exact():
    return jax_and_port(ba_map(obs_noise=0.0))


@pytest.fixture(scope="module")
def noisy():
    return jax_and_port(ba_map(obs_noise=0.3))


def _stats(stats):
    return [float(s) for s in stats]


def test_residual_and_jacobian_grid(noisy):
    js, ts = noisy
    jp, tp = jba.problem_from_map(js), ba.problem_from_map(ts)
    r, (A, B) = jax.jit(jba._res_jac_grid)(jp.cam_params, jp.points, jp.obs_uv, jp.K, jp.intr)
    rt, At, Bt = ba._res_jac_grid(tp.cam_params, tp.points, tp.obs_uv, tp.K)
    w = N(ba._weights(tp)) > 0
    assert w.sum() == 5 * 300
    np.testing.assert_allclose(N(rt)[w], N(r)[w], atol=1e-3)
    np.testing.assert_array_equal(N(ba._res_grid(tp.cam_params, tp.points, tp.obs_uv, tp.K)),
                                  N(rt))
    for ours, ref in ((At, A), (Bt, B)):
        ours, ref = N(ours)[w], N(ref)[w]  # (n, 2, k)
        scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
        assert (np.abs(ours - ref) <= 1e-4 * np.maximum(scale, 1.0)).all()
    np.testing.assert_array_equal(N(tp.cam_params)[:5], N(jp.cam_params)[:5])


@pytest.mark.parametrize("huber", [0.0, 2.0])
def test_cost(noisy, huber):
    js, ts = noisy
    ours = float(ba._cost(ba.problem_from_map(ts), huber))
    ref = float(jba._cost(jba.problem_from_map(js), huber_delta=huber))
    assert ref > 10.0
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


def test_lm_solve_step(noisy):
    js, ts = noisy
    solve = jax.jit(jba._lm_solve, static_argnames=("cg_iters",))
    dc, dp, _ = solve(jba.problem_from_map(js), jnp.float32(1e-3), cg_iters=20)
    tdc, tdp, tdt = ba._lm_solve(ba.problem_from_map(ts), torch.tensor(1e-3), 20)
    np.testing.assert_array_equal(N(tdt), 0.0)  # the intrinsics stay put
    assert np.abs(N(dc)).max() > 1e-2
    np.testing.assert_allclose(N(tdc), N(dc), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(N(tdp), N(dp), rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(N(tdc)[0], 0.0)  # frozen gauge camera


def test_bundle_adjust_noiseless(exact):
    js, ts = exact
    jout, jst = jba.bundle_adjust_map(js, max_iterations=ITERS, cg_iters=CG)
    tout, tst = ba.bundle_adjust_map(ts, max_iterations=ITERS, cg_iters=CG)
    jst, tst = _stats(jst), _stats(tst)
    assert jst[1] < 1e-3 and tst[1] < 1e-3
    np.testing.assert_allclose(tst[0], jst[0], rtol=1e-5)
    assert tst[2:] == jst[2:]  # iterations, accepted
    for c in range(5):
        assert rotation_angle_deg(N(tout.poses)[c, :, :3], N(jout.poses)[c, :, :3]) < 1e-2


def test_bundle_adjust_noisy(noisy):
    js, ts = noisy
    _, jst = jba.bundle_adjust_map(js, max_iterations=ITERS, cg_iters=CG)
    _, tst = ba.bundle_adjust_map(ts, max_iterations=ITERS, cg_iters=CG)
    jst, tst = _stats(jst), _stats(tst)
    assert jst[1] < 0.3  # the noise floor, 2 sigma^2 = 0.18 px^2
    np.testing.assert_allclose(tst[1], jst[1], rtol=1e-3)
    assert tst[2:] == jst[2:]


def test_stops_on_damping_before_max_iterations(exact):
    """With every observation masked out the cost is exactly 0, no step
    improves it, and the damping grows x4 per step from 1e-3 until it
    reaches 1e5 after 14 steps: the JAX while_loop stops there."""
    js, ts = exact
    js = js._replace(obs_mask=jnp.zeros_like(js.obs_mask))
    ts = ts._replace(obs_mask=torch.zeros_like(ts.obs_mask))
    jout, jst = jba.bundle_adjust_map(js, max_iterations=20, cg_iters=CG)
    tout, tst = ba.bundle_adjust_map(ts, max_iterations=20, cg_iters=CG)
    assert _stats(tst) == _stats(jst) == [0.0, 0.0, 14.0, 0.0]
    np.testing.assert_array_equal(N(tout.points), N(ts.points))


def test_frozen_camera_unchanged_bitwise(exact):
    _, ts = exact
    prob = ba.problem_from_map(ts)
    out, stats = ba.run_ba(prob, max_iterations=ITERS, cg_iters=CG)
    assert int(stats.accepted) > 0
    np.testing.assert_array_equal(N(out.cam_params)[0], N(prob.cam_params)[0])
    assert np.abs(N(out.cam_params)[1:5] - N(prob.cam_params)[1:5]).max() > 1e-4
    pose0 = lie.rt_to_matrix(prob.cam_params[0, :3], prob.cam_params[0, 3:])
    np.testing.assert_array_equal(N(ba.write_back_to_map(ts, out).poses)[0], N(pose0))
    np.testing.assert_allclose(N(pose0), N(ts.poses)[0], atol=1e-6)


def test_garbage_in_masked_cells_ignored(exact):
    js, ts = exact
    mask = N(ts.obs_mask)
    uv = N(ts.obs_uv).copy()
    uv[~mask] = 1e6
    clean, st_clean = ba.bundle_adjust_map(ts, max_iterations=ITERS, cg_iters=CG)
    dirty, st_dirty = ba.bundle_adjust_map(ts._replace(obs_uv=T(uv)), max_iterations=ITERS,
                                           cg_iters=CG)
    assert _stats(st_dirty) == _stats(st_clean)
    np.testing.assert_array_equal(N(dirty.poses), N(clean.poses))
    np.testing.assert_array_equal(N(dirty.points), N(clean.points))
    _, jst = jba.bundle_adjust_map(js._replace(obs_uv=J(uv)), max_iterations=ITERS, cg_iters=CG)
    assert _stats(st_dirty)[2:] == _stats(jst)[2:]


def test_bundle_adjust_window(noisy):
    """5 cameras, window 3 (camera 2 frozen), point window 256 of 512
    slots: slots [44, 300) adjust, the rest stays bitwise."""
    js, ts = noisy
    kw = dict(window_cams=3, window_points=256, max_iterations=15, cg_iters=20, freeze_cams=1)
    jout, jst = jba.bundle_adjust_window(js, **kw)
    tout, tst = ba.bundle_adjust_window(ts, **kw)
    jst, tst = _stats(jst), _stats(tst)
    assert tst[1] < 0.1 * tst[0]
    np.testing.assert_allclose(tst[:2], jst[:2], rtol=1e-3)
    np.testing.assert_array_equal(N(tout.poses)[:3], N(ts.poses)[:3])
    np.testing.assert_array_equal(N(tout.points)[:44], N(ts.points)[:44])
    np.testing.assert_array_equal(N(tout.points)[300:], N(ts.points)[300:])
    np.testing.assert_allclose(N(tout.points)[44:300], N(jout.points)[44:300], atol=2e-3)
    for c in (3, 4):
        assert rotation_angle_deg(N(tout.poses)[c, :, :3], N(jout.poses)[c, :, :3]) < 1e-2


def test_convert_carries_ba_problem_and_stats(noisy):
    """utils/convert.py carries the JAX package's BAProblem and BAStats; the
    port's run_ba continues from the converted problem as JAX's does."""
    js, _ = noisy
    jprob = jba.problem_from_map(js)
    _, jst = jba.run_ba(jprob, max_iterations=ITERS, cg_iters=CG)

    def leaves(x):
        return type(x)(*[np.asarray(a) for a in x])

    tprob = convert.to_torch(leaves(jprob))
    assert isinstance(tprob, ba.BAProblem) and tprob.frozen.dtype == torch.bool
    stats = convert.to_torch(leaves(jst))
    assert isinstance(stats, ba.BAStats) and stats.iterations.dtype == torch.int32
    tout, tst = ba.run_ba(tprob, max_iterations=ITERS, cg_iters=CG)
    assert _stats(tst)[2:] == _stats(jst)[2:]
    np.testing.assert_allclose(float(tst.final_cost), float(jst.final_cost), rtol=1e-3)
    back = convert.to_numpy(tout)
    assert type(back) is ba.BAProblem and back.points.dtype == np.float32
