"""The port's view graph, bootstrap guard, loop closure and finalize against
the benchmark's float64 reference (``portbench/reference_viewgraph.py``),
on the CPU.

One auto-bootstrap run with loop closure and finalize on a 7-frame
staircase (320x240, 3 deg a step) is recorded by the benchmark's own
recorder (``portbench/drivers/viewgraph.py``: every pair's K1 answer, E,
inliers and 8-point refit, every injection's maps before and after). Its pairs are held
to the reference within the tolerances below, its choices exactly; a run
with the tracer off gives the same bits; a planted wrong bootstrap is
retried once by the guard and the map still lands.
"""

import ast
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import reference
from portbench import reference_viewgraph as rv
from portbench.drivers import viewgraph as driver
from sfm_mvs_tpu_torch.models import exhaustive, incremental
from sfm_mvs_tpu_torch.utils import config, evaluate, profiling
from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence

REPO = Path(__file__).resolve().parent.parent
N_FRAMES = 7

# Tolerances, each with its reason (readings on this scene in brackets):
# - an E-inlier count against the float64 recount of the same E: a
#   correspondence within float32 rounding of the 2 px threshold may flip,
#   so a share of the count [0 on every pair];
INLIER_TOL = 0.01
# - the pose against the float64 decomposition of the same E: float32's SVD
#   of an E whose two singular values are equal to ~1e-7 fixes U W V^T to
#   ~5e-4 rad only (LAPACK on the CPU) [to 0.037 deg];
POSE_TOL_DEG = 0.1
# - the parallax under that pose: the same rotation, averaged [to 8e-4 deg];
PARALLAX_TOL_DEG = 0.01
# - a pair's first inlier-weighted 8-point solve (the E-RANSAC's refit)
#   against the float64 solve of the same weighted correspondences, RMS of
#   the Sampson distances' difference: float32's design matrix and SVDs
#   [to 2.6e-4 px; inputs rounded to bfloat16 0.13 px and more];
SOLVE_TOL_PX = 0.005
# - finalize's reported cost against the float64 cost of its map: float32
#   sums of ~1e3 squared residuals [~2e-6].
COST_TOL = 1e-4


def _cfg(K, **kw):
    return config.SfmConfig(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
        downscale=1, bootstrap="auto", view_graph_window=8, loop_close_pairs=4,
        frontend=config.FrontendConfig(max_features=1024, num_octaves=4, upsample_input=False,
                                       contrast_threshold=0.012, lowe_ratio=0.75),
        ransac=config.RansacConfig(essential_iters=256, pnp_iters=256),
        ba=config.BaConfig(enabled=True, max_iterations=3),
        map=config.MapConfig(max_cameras=16, max_points=4096), **kw)


@pytest.fixture(scope="module")
def scene():
    imgs, Rt, K = render_staircase_sequence(num_cameras=N_FRAMES, arc_degrees=18,
                                            image_size=(320, 240), focal=400.0)
    return [np.asarray(g, np.float32) for g in imgs], np.asarray(Rt, np.float64), K


def _run(scene, traced: bool):
    """run + finalize: (sfm, finalized map, recorder's graphs and injections,
    the tracer's export or None)."""
    imgs, _, K = scene
    rec = driver.GraphRecorder()
    profiling.reset()
    if traced:
        profiling.enable()
    try:
        sfm = incremental.IncrementalSfM(_cfg(K), device="cpu")
        sfm.run(imgs, seed=7)
        state = sfm.finalize(ba_iterations=8)
        exported = profiling.export() if traced else None
    finally:
        profiling.disable()
        profiling.reset()
        rec.close()
    graphs, injects = rec.take()
    return sfm, state, graphs, injects, exported


@pytest.fixture(scope="module")
def traced(scene):
    return _run(scene, traced=True)


@pytest.mark.parametrize("which", [0, 1], ids=["windowed_graph", "full_graph"])
def test_view_graph_pairs_against_the_float64_reference(scene, traced, which):
    _, _, K = scene
    _, _, graphs, _, _ = traced
    Kinv = torch.linalg.inv(torch.as_tensor(K, dtype=torch.float64))
    cfg = _cfg(K)
    focal = 0.5 * float(K[0, 0] + K[1, 1])
    gr = graphs[which]
    assert len(gr.pairs) == len(gr.graph.pair_i) == 21  # 7 frames: every pair lies within 8
    posed = 0
    for k, p in enumerate(gr.pairs):
        m = p.matches
        assert reference.k1_gap(p.f0.desc, p.f1.desc, p.f0.valid, p.f1.valid,
                                cfg.frontend.lowe_ratio, m.idx1, m.valid) == 0.0  # plain 2-NN
        n0 = rv.normalize(p.f0.xy[m.idx0.long()], Kinv)
        n1 = rv.normalize(p.f1.xy[m.idx1.long()], Kinv)
        ni = int(gr.graph.num_inliers[k])
        assert int(gr.graph.num_matches[k]) == int(m.valid.sum())
        assert rv.inlier_gap(ni, p.E, n0, n1, m.valid, focal,
                             cfg.ransac.essential_threshold_px) <= INLIER_TOL
        if ni < driver.POSE_MIN_INLIERS:
            continue
        posed += 1
        R, t = rv.decompose(p.E, n0, n1, p.inliers)
        assert rv.pose_gap(gr.graph.R[k], gr.graph.t[k], R, t) <= POSE_TOL_DEG
        assert abs(float(gr.graph.parallax_deg[k]) - rv.parallax_deg(R, n0, n1, p.inliers)) \
            <= PARALLAX_TOL_DEG
    assert posed >= 10


@pytest.mark.parametrize("which", [0, 1], ids=["windowed_graph", "full_graph"])
def test_the_eight_point_solves_are_the_float64_solves(scene, traced, which):
    _, _, K = scene
    _, _, graphs, _, _ = traced
    Kinv = torch.linalg.inv(torch.as_tensor(K, dtype=torch.float64))
    focal = 0.5 * float(K[0, 0] + K[1, 1])
    solved = 0
    for p in graphs[which].pairs:
        E, w = p.refit
        if int((w > 0).sum()) < driver.POSE_MIN_INLIERS:
            continue
        m = p.matches
        n0 = rv.normalize(p.f0.xy[m.idx0.long()], Kinv)
        n1 = rv.normalize(p.f1.xy[m.idx1.long()], Kinv)
        assert rv.solve_gap(E, n0, n1, w, focal) <= SOLVE_TOL_PX
        solved += 1
    assert solved >= 10


def _graph(pair_i, pair_j, inliers, parallax):
    n = len(pair_i)
    return exhaustive.ViewGraph(
        pair_i=np.asarray(pair_i), pair_j=np.asarray(pair_j),
        num_matches=np.asarray(inliers, np.int32), num_inliers=np.asarray(inliers, np.int32),
        R=np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)), t=np.zeros((n, 3), np.float32),
        adjacency=np.zeros((8, 8), np.int32), parallax_deg=np.asarray(parallax, np.float32))


# Ties in inlier count, every parallax level, pairs below the inlier floor.
SYNTHETIC = _graph([0, 0, 1, 1, 2, 3, 0, 4], [1, 2, 2, 5, 6, 7, 4, 7],
                   [80, 80, 120, 60, 60, 40, 200, 80], [2.0, 0.5, 0.2, 1.5, 1.5, 3.0, 0.0, 0.3])


def _reference_candidates(g):
    return rv.bootstrap_candidates(g.pair_i, g.pair_j, g.num_inliers, g.parallax_deg)


@pytest.mark.parametrize("which", ["run", "synthetic"])
def test_choice_rules_are_the_references(traced, which):
    graphs = [gr.graph for gr in traced[2]] if which == "run" else [SYNTHETIC]
    for g in graphs:
        cands = _reference_candidates(g)
        assert exhaustive.bootstrap_candidates(g) == cands
        assert exhaustive.best_bootstrap_pair(g) == cands[0]
        for k in (1, 2, 4, 10):
            assert exhaustive.strongest_loop_pairs(g, k) == rv.loop_pairs(
                g.pair_i, g.pair_j, g.num_inliers, k)
    if which == "synthetic":
        # ties: the lower pair index first
        assert cands == [(0, 1), (1, 5), (2, 6), (0, 2), (4, 7), (0, 4), (1, 2)]
        assert exhaustive.strongest_loop_pairs(SYNTHETIC, 3) == [(0, 4), (4, 7), (1, 5)]


def test_the_run_took_the_references_bootstrap_and_loop_pairs(traced):
    sfm, _, graphs, injects, _ = traced
    guard = (incremental.BOOTSTRAP_MAX_ROT_DEG, incremental.BOOTSTRAP_MAX_DIR_DEG,
             incremental.BOOTSTRAP_STREAMS, incremental.BOOTSTRAP_PAIRS)
    record = driver.PassRecord(1, N_FRAMES, None, {}, [], 0, graphs, injects,
                               sfm.bootstrap_attempts, sfm.bootstrap_pair, [])
    assert driver.bootstrap_sound(record, guard)
    assert driver.loop_pairs_sound(record, sfm.config)
    assert len(injects) == 2 * 4


def test_injected_observations_pass_the_float64_gate(scene, traced):
    _, _, K = scene
    injects = traced[3]
    counts = [driver.inject_counts(r, torch.as_tensor(K, dtype=torch.float64)) for r in injects]
    assert sum(c[0] for c in counts) > 0
    assert sum(c[1] for c in counts) == 0


def test_finalize_cost_is_the_float64_cost(scene, traced):
    _, Rt, K = scene
    sfm, m, _, _, _ = traced
    ref = reference.reprojection_cost(m.poses, m.points, m.obs_uv, m.obs_mask, m.point_valid,
                                      m.cam_valid, K)
    assert reference.relative_gap(sfm.finalize_info["round1_cost"], ref) <= COST_TOL
    assert sfm.finalize_info["loop_closure_obs"] > 0
    assert int(m.cam_valid.sum()) == N_FRAMES
    assert evaluate.ate_rmse(m.poses[:N_FRAMES].double().numpy(), Rt) < 0.05


NEW_SPANS = {"viewgraph", "viewgraph.match", "viewgraph.essential", "viewgraph.pose",
             "viewgraph.copy", "loop_close", "loop_close.inject", "finalize", "finalize.compact",
             "finalize.robust", "finalize.merge", "finalize.cull"}
NEW_COUNTERS = {"viewgraph.pairs", "viewgraph.useful_pairs", "loop_close.pairs",
                "loop_close.injected", "finalize.merged"}


def test_the_tracer_opens_every_new_span_and_counter(traced):
    sfm, _, graphs, _, exported = traced
    summary = profiling.summary(exported)
    spans, counters = summary["spans"], summary["counters"]
    assert NEW_SPANS <= set(spans) and NEW_COUNTERS <= set(counters)
    pairs = sum(len(gr.graph.pair_i) for gr in graphs)
    assert counters["viewgraph.pairs"] == pairs == spans["viewgraph.essential"]["calls"]
    assert spans["viewgraph"]["calls"] == 2 and spans["finalize"]["calls"] == 1
    useful = sum(int((gr.graph.num_inliers >= exhaustive.LOOP_MIN_INLIERS).sum())
                 for gr in graphs)
    assert counters["viewgraph.useful_pairs"] == useful
    assert counters["loop_close.pairs"] == 4
    assert counters["loop_close.injected"] == sfm.finalize_info["loop_closure_obs"]
    assert counters["finalize.merged"] == sfm.finalize_info["merged_points"]
    assert counters.get("bootstrap.retries", 0) == len(sfm.bootstrap_attempts) - 1
    # the frame records still hold their own frames' spans
    assert sfm.stats[0]["spans"]["viewgraph"]["calls"] == 1


def test_with_the_tracer_off_the_outputs_are_the_same_bits(scene, traced):
    sfm_on, m_on, graphs_on, _, _ = traced
    sfm_off, m_off, graphs_off, _, _ = _run(scene, traced=False)
    for name, a, b in zip(m_on._fields, m_on, m_off):
        assert torch.equal(a, b), name
    for g_on, g_off in zip(graphs_on, graphs_off):
        for name, a, b in zip(g_on.graph._fields, g_on.graph, g_off.graph):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert sfm_on.bootstrap_pair == sfm_off.bootstrap_pair
    assert {k: v for k, v in sfm_on.finalize_info.items()} == sfm_off.finalize_info


def test_a_planted_wrong_bootstrap_is_retried(scene, monkeypatch):
    """The bootstrap's first try comes back with its pose turned by 5 deg:
    the guard sees it against the view graph's pair, tries the next
    stream, and the map lands."""
    imgs, Rt, K = scene
    own = incremental.bootstrap
    calls = []

    def planted(gen, f0, f1, K_, cfg):
        tv = own(gen, f0, f1, K_, cfg)
        calls.append(1)
        if len(calls) > 1:
            return tv
        a = math.radians(5.0)
        turn = torch.tensor([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                             [-math.sin(a), 0.0, math.cos(a)]], dtype=tv.pose1.dtype)
        return tv._replace(pose1=torch.cat([turn @ tv.pose1[:, :3], tv.pose1[:, 3:]], 1))

    monkeypatch.setattr(incremental, "bootstrap", planted)
    profiling.reset()
    profiling.enable()
    try:
        sfm = incremental.IncrementalSfM(_cfg(K), device="cpu")
        state = sfm.run(imgs, seed=7)
        counters = profiling.summary(profiling.export())["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    first, second = sfm.bootstrap_attempts[:2]
    assert first.rot_deg > incremental.BOOTSTRAP_MAX_ROT_DEG and second.excess <= 1.0
    assert counters["bootstrap.retries"] == 1 and len(sfm.bootstrap_attempts) == 2
    assert (second.a, second.b, second.stream) == (first.a, first.b, 1)
    cv = state.cam_valid.numpy()
    assert cv.sum() == N_FRAMES
    assert evaluate.ate_rmse(state.poses.numpy()[cv], Rt) < 0.05


def _top_imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_the_reference_imports_neither_jax_nor_the_port():
    for name in ("reference_viewgraph.py", "reference.py"):
        tops = _top_imports(REPO / "portbench" / name)
        assert not tops & {"jax", "jaxlib", "sfm_mvs_tpu", "sfm_mvs_tpu_torch"}, name
    code = ("import sys\nimport portbench.reference_viewgraph\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'sfm_mvs_tpu', 'sfm_mvs_tpu_torch'}))\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
