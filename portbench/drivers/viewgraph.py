"""Driver ``viewgraph``: the offline exhaustive pipeline, pass after pass.

A pass stages the rendered frames as host arrays (float32 in [0, 1], as a
user's image loader gives them), then calls the port as isfm.py's
pipeline runs: ``IncrementalSfM(cfg).run(images, seed=...)`` with
``cfg.bootstrap == "auto"`` (detection of every frame, the windowed view
graph, the guarded bootstrap on the pair it picks, registration walking
out from it with per-frame BA), then ``.finalize(ba_iterations=...)``
(compaction, the full view graph over every camera pair, loop closures
injected both ways, the robust BA, duplicate merging, cull + global BA),
synchronized (``finalize`` in the configuration's iterations). Closed
loop, one caller; the window ends with the pass that
crosses ``--seconds``. A frame counts as produced when it is posed in its
pass's finalized map: a live camera there, as many as the run reports
posed at most.

Traffic parameters: ``warmup_frames`` (the frames of the throw-away pass
run in set-up through the same two calls), ``checked_share`` (the share
of each view graph's pairs, drawn from the seed, whose K1 answers and
geometry the reference recomputes; the pairs the bootstrap tried and the
loop-closure pairs are always checked) and ``profile_seconds`` (the
--trace 1 stretch: that long inside the full view graph of the window's
last pass, or of the first pass after it where the stretch had not
begun; never in the window's first pass, so that a whole ``finalize``
precedes it).

The reference (``reference_viewgraph.py``, ``reference.py``) judges every
pass: its checked pairs, its bootstrap and loop-closure choices, every
injected observation, its finalized map's cost and its trajectory.
"""

from __future__ import annotations

import math
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from portbench import pipeline, reference
from portbench import reference_viewgraph as rv
from portbench.harness import (Outcome, Profiler, TraceData, power_limit_w, seed_int, seed_stream,
                               sync, window_start)

# A pair's pose and parallax are compared where its E has this many inliers
# (the port's floor of a loop-closure pair): below it E is not determined.
POSE_MIN_INLIERS = 30


def tiny(config: dict, traffic: dict):
    """The cell cut for the CPU tests: 7 frames of 320x240 over 18 deg,
    detected without upsampling (a quarter of the pixels of 240x160
    upsampled, with enough features for loop closures), a map of 16 cameras
    and 4096 points, 3 BA iterations a frame and 8 in finalize, 4 warm-up
    frames, every pair checked, a 0.3 s stretch."""
    config = pipeline.tiny(config)
    small = dict(image_size=[320, 240], fx=400.0, fy=401.0, cx=159.0, cy=121.0)
    config["scene"].update(small, num_cameras=7, arc_degrees=18.0)
    config["sfm"].update({k: small[k] for k in ("fx", "fy", "cx", "cy")})
    config["sfm"]["frontend"]["upsample_input"] = False
    config["sfm"]["map"] = {"max_cameras": 16, "max_points": 4096}
    config["sfm"]["ba"] = dict(config["sfm"]["ba"], max_iterations=3)
    config["finalize"] = {"max_iterations": 8}
    return config, dict(traffic, warmup_frames=4, checked_share=1.0, profile_seconds=0.3)


class PairRecord(NamedTuple):
    """One pair of a view graph as the port computed it: the features it
    matched, K1's answer, and the E, correspondences and inliers its pose
    was recovered from (references to the port's tensors, no copy)."""

    f0: object  # Features of the pair's first frame
    f1: object
    matches: object  # matching.Matches
    E: torch.Tensor  # (3, 3)
    inliers: torch.Tensor  # (M,) bool
    refit: tuple  # (E, weights): the E-RANSAC's first inlier-weighted 8-point solve, or None


class GraphRecord(NamedTuple):
    graph: object  # the ViewGraph the port returned
    pairs: list  # PairRecord per pair, in the graph's order (None where not checked)


class InjectRecord(NamedTuple):
    before: object  # the MapState inject_reobservations received
    after: object  # the MapState it returned
    cam_i: int
    cam_j: int  # the camera the observations went into
    gate_px: float


class PassRecord(NamedTuple):
    pass_id: int
    frames: int  # frames fed
    map: object  # the finalized MapState
    info: dict  # finalize_info
    registered: list  # frame ids the run reports posed, in camera order
    cameras: int  # live cameras of the finalized map
    graphs: list  # GraphRecord: the windowed graph, then finalize's full graph
    injects: list  # InjectRecord per direction
    attempts: list  # the bootstrap's tries (incremental.BootstrapAttempt)
    bootstrap_pair: tuple
    checked: list  # (graph index, pair index) whose pair the reference recomputes


class GraphRecorder:
    """Wraps the port's view graph for the run (``exhaustive``'s
    ``build_view_graph``, ``_pair_geometry``, ``_match``, ``recover_pose``
    and ``inject_reobservations``, and inside a pair ``epipolar``'s
    ``essential_eight_point``): keeps each pass's graphs with every pair's
    K1 answer, E, inliers and first inlier-weighted 8-point solve (the
    E-RANSAC's refit), and each loop-closure injection's maps
    before and after (references, no copy); times each graph on the
    synchronized host clock where `timed`; starts and stops the profiled
    stretch inside a graph. In the control, K1's answers are the
    reference's TF32 2-NN, the E-RANSAC's 8-point solves, its inliers and
    the recovered pose the reference's bfloat16 8-point solve, Sampson
    scoring and decomposition."""

    def __init__(self, control: bool = False):
        from sfm_mvs_tpu_torch.models import exhaustive
        from sfm_mvs_tpu_torch.ops import epipolar, ransac

        self.ex, self.ransac, self.control = exhaustive, ransac, control
        self.saved: list = []
        for attr in ("build_view_graph", "_pair_geometry", "_match", "recover_pose",
                     "inject_reobservations"):
            fn = exhaustive.__dict__[attr]
            self.saved.append((exhaustive, attr, fn))
            setattr(exhaustive, attr, getattr(self, "_" + attr.lstrip("_")))
        fn = epipolar.__dict__["essential_eight_point"]
        self.saved.append((epipolar, "essential_eight_point", fn))
        epipolar.essential_eight_point = self._essential_eight_point
        self.orig = {attr: fn for _, attr, fn in self.saved}
        self._in_pair = False
        self.graphs: list = []
        self.injects: list = []
        self._pairs: list = []
        self._cur: dict = {}
        self.timed = False  # time each graph (a --trace 1 window before its stretch)
        self.seconds: list = []  # per timed graph
        self.pair_counts: list = []
        self.on_full_graph = None  # () -> None, called as a graph of every pair begins
        self.stretch = None  # () -> None, called at a graph's first pair to start the stretch
        self.stretch_check = None  # () -> None, called after each pair while it runs

    def _build_view_graph(self, images, cfg=None, **kw):
        if not kw.get("window") and self.on_full_graph is not None:  # finalize's graph
            self.on_full_graph()
        timed = self.timed
        feats = kw.get("feats")
        device = feats[0].xy.device if feats else torch.device("cpu")
        if timed:
            sync(device)
            t = time.perf_counter()
        graph = self.orig["build_view_graph"](images, cfg, **kw)
        if timed and self.timed:  # the stretch did not begin inside it
            sync(device)
            self.seconds.append(time.perf_counter() - t)
            self.pair_counts.append(len(graph.pair_i))
        self.graphs.append(GraphRecord(graph, self._pairs))
        self._pairs = []
        return graph

    def _pair_geometry(self, gen, f0, f1, K, cfg):
        if self.stretch is not None:
            start, self.stretch = self.stretch, None
            start()
        self._cur, self._in_pair = {}, True
        own = self.ransac.__dict__["ransac_essential"]
        if self.control:  # the reference's bfloat16 scoring in the E-RANSAC's place
            self.ransac.ransac_essential = self._control_essential(own)
        try:
            out = self.orig["_pair_geometry"](gen, f0, f1, K, cfg)
        finally:
            self.ransac.ransac_essential = own
            self._in_pair = False
        c = self._cur
        self._pairs.append(PairRecord(f0, f1, c.get("m"), c.get("E"), c.get("inliers"),
                                      c.get("refit")))
        if self.stretch_check is not None:
            self.stretch_check()
        return out

    def _essential_eight_point(self, pts1, pts2, weights=None, method="svd"):
        solve = self.orig["essential_eight_point"]
        if not self._in_pair:  # the bootstrap's and the injections' E-RANSAC
            return solve(pts1, pts2, weights, method)
        if self.control:  # the reference's bfloat16 8-point solve in the port's
            E = rv.eight_point(pts1, pts2, weights, torch.bfloat16).to(pts1.dtype)
        else:
            E = solve(pts1, pts2, weights, method)
        if weights is not None:
            self._cur.setdefault("refit", (E, weights))
        return E

    def _control_essential(self, own):
        def scored(gen, n0, n1, mask, focal, **kw):
            res = own(gen, n0, n1, mask, focal, **kw)
            inl = rv.inliers(res.model, n0, n1, mask, float(focal), kw["threshold_px"],
                             torch.bfloat16)
            return res._replace(inliers=inl, num_inliers=inl.sum())
        return scored

    def _match(self, f0, f1, cfg):
        if self.control:
            from sfm_mvs_tpu_torch.ops.matching import Matches

            fc = cfg.frontend
            j, ok = reference.knn2(f0.desc, f1.desc, f0.valid, f1.valid, fc.lowe_ratio,
                                   precision="tf32")
            rows = torch.arange(f0.desc.shape[0], dtype=torch.int32, device=f0.desc.device)
            m = Matches(idx0=rows, idx1=j.to(torch.int32), valid=ok)
        else:
            m = self.orig["_match"](f0, f1, cfg)
        self._cur["m"] = m
        return m

    def _recover_pose(self, E, n0, n1, mask):
        self._cur["E"], self._cur["inliers"] = E, mask
        if self.control:  # the reference's bfloat16 decomposition
            R, t = rv.decompose(E, n0, n1, mask, torch.bfloat16)
            return R.to(E.dtype), t.to(E.dtype), mask
        return self.orig["recover_pose"](E, n0, n1, mask)

    def _inject_reobservations(self, state, cam_i, cam_j, *a, **kw):
        new, n = self.orig["inject_reobservations"](state, cam_i, cam_j, *a, **kw)
        self.injects.append(InjectRecord(state, new, int(cam_i), int(cam_j),
                                          float(kw.get("max_err_px"))))
        return new, n

    def take(self):
        """The graphs and injections recorded since the last call."""
        out = (self.graphs, self.injects)
        self.graphs, self.injects = [], []
        return out

    def close(self):
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)


class Runner:
    """One pass of the offline pipeline on the staged frames."""

    def __init__(self, ctx, host8: np.ndarray, cfg, rec: GraphRecorder):
        from sfm_mvs_tpu_torch.models import incremental

        self.ctx, self.host8, self.cfg, self.rec, self.inc = ctx, host8, cfg, rec, incremental
        self.fin_iters = ctx.config["finalize"]["max_iterations"]
        self.rng = seed_stream(ctx.seed, 5)
        self.share = ctx.traffic["checked_share"]

    def run_pass(self, pass_id: int, n: int) -> PassRecord:
        """One synchronized pass over the first n frames."""
        images = [self.host8[i].astype(np.float32) / np.float32(255.0) for i in range(n)]
        sfm = self.inc.IncrementalSfM(self.cfg, device=self.ctx.device)
        sfm.run(images, seed=seed_int(self.ctx.seed, 2, pass_id))
        state = sfm.finalize(ba_iterations=self.fin_iters)
        sync(self.ctx.device)
        graphs, injects = self.rec.take()
        a, b = sfm.bootstrap_pair
        registered = sorted({a, b} | {s["frame"] for s in sfm.stats if s["accepted"]})
        checked = self.checked_pairs(graphs, sfm, injects)
        for g, gr in enumerate(graphs):  # drop what the reference does not read
            keep = {k for gg, k in checked if gg == g}
            gr.pairs[:] = [p if k in keep else None for k, p in enumerate(gr.pairs)]
        return PassRecord(pass_id, n, state, dict(sfm.finalize_info), registered,
                          int(state.cam_valid.sum()), graphs, injects,
                          list(sfm.bootstrap_attempts), (a, b), checked)

    def checked_pairs(self, graphs, sfm, injects) -> list:
        """(graph, pair) indices: a share of each graph's pairs drawn from the
        seed, the pairs the bootstrap tried and the loop-closure pairs."""
        out = set()
        for g, gr in enumerate(graphs):
            draw = self.rng.random(len(gr.pairs))
            out |= {(g, k) for k in np.nonzero(draw < self.share)[0].tolist()}
        ex = self.rec.ex
        if graphs:
            for t in sfm.bootstrap_attempts:
                out.add((0, ex.pair_index(graphs[0].graph, t.a, t.b)))
        if len(graphs) > 1:
            for r in injects:
                i, j = min(r.cam_i, r.cam_j), max(r.cam_i, r.cam_j)
                out.add((1, ex.pair_index(graphs[-1].graph, i, j)))
        return sorted(out)


def run(ctx) -> Outcome:
    ctx.log("start")
    import sfm_mvs_tpu_torch  # noqa: F401  (float32 products, TF32 off)
    from sfm_mvs_tpu_torch.models import incremental
    from sfm_mvs_tpu_torch.ops import matching_cuda

    # The guard's rule, which the reference follows; a program without the
    # guard stops here, before any work.
    guard = (incremental.BOOTSTRAP_MAX_ROT_DEG, incremental.BOOTSTRAP_MAX_DIR_DEG,
             incremental.BOOTSTRAP_STREAMS, incremental.BOOTSTRAP_PAIRS)
    if ctx.control:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    ctx.log("import")
    if ctx.device.type == "cuda":
        matching_cuda.build()
        ctx.log("K1 build")
    tr = ctx.traffic
    cfg = pipeline.sfm_config(ctx.config)
    sc = pipeline.render(ctx)
    host8 = pipeline.stage_u8(sc.images).cpu().numpy()  # the decoded frames in host memory
    ctx.log("render")
    n = host8.shape[0]
    rec = GraphRecorder(control=ctx.control)
    runner = Runner(ctx, host8, cfg, rec)
    runner.run_pass(0, min(n, tr["warmup_frames"]))
    rec.take()
    sync(ctx.device)
    ctx.log("warm-up")
    window_start(ctx)
    setup_s = time.perf_counter() - ctx.t_start

    data = TraceData(spans={}, counts={}) if ctx.trace else None
    prof = Profiler(ctx.device) if ctx.trace else None
    rec.timed = ctx.trace
    state = {"stretched": False, "tail_s": None, "t0": 0.0}
    t_win = time.perf_counter()
    deadline = t_win + ctx.seconds

    def start_stretch():
        rec.timed = False
        prof.start()
        state["t0"] = time.perf_counter()
        rec.stretch_check = check_stretch

    def check_stretch():
        if time.perf_counter() - state["t0"] >= tr["profile_seconds"]:
            rec.stretch_check = None
            prof.stop(data)
            state["stretched"] = True

    passes, graph_t = [], {}

    def full_graph():
        # The stretch begins at the graph's first pair where this pass is
        # predicted to cross the deadline (the previous pass's time from its
        # full graph to its end), never in the window's first pass.
        graph_t[len(passes) + 1] = now = time.perf_counter()
        tail = state["tail_s"]
        if (prof is not None and not state["stretched"] and passes
                and (tail is None or now + tail >= deadline)):
            rec.stretch = start_stretch

    rec.on_full_graph = full_graph
    while True:
        passes.append(runner.run_pass(len(passes) + 1, n))
        now = time.perf_counter()
        if len(passes) in graph_t:
            state["tail_s"] = now - graph_t[len(passes)]
        if now >= deadline and (prof is None or state["stretched"]):
            break
    window_s = time.perf_counter() - t_win
    rec.on_full_graph = None
    if prof is not None:
        if prof.prof is not None and not state["stretched"]:  # a stretch cut short by its graph
            prof.stop(data)
        data.spans["viewgraph"] = rec.seconds
        data.counts["viewgraph_pairs"] = rec.pair_counts
        spans = (data.program.get("before") or {}).get("spans", {})
        top = sorted(spans.items(), key=lambda kv: -kv[1]["ms"])[:16]
        print("portbench: host ms by span before the stretch: " + ", ".join(
            f"{k} {v['ms']:.0f} ({v['calls']})" for k, v in top), file=sys.stderr)
        data.power_limit_w = power_limit_w() if ctx.device.type == "cuda" else None

    produced = sum(min(p.cameras, len(p.registered)) for p in passes)
    fed = sum(p.frames for p in passes)
    end_to_end = {"frames_per_s": produced / window_s}
    keep = {"host8": host8}

    def free():
        rec.close()
        keep.clear()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge() -> dict:
        return readings(passes, sc, cfg, guard)

    return Outcome(setup_s=setup_s, attempted=fed, failed=fed - produced, end_to_end=end_to_end,
                   trace=data, free=free, judge=judge)


def readings(passes, sc, cfg, guard) -> dict:
    """The numbers compared against the cell's limits, worst over the passes.

    k1_gap: the checked pairs' K1 answers against the float64 2-NN
    (``reference.k1_gap``). pair_inlier_gap: a checked pair's E-inlier count
    against the float64 recount of its own E over its matches, as a share.
    essential_solve_gap: a checked pair's first inlier-weighted 8-point
    solve (the E-RANSAC's refit) against the float64 8-point solve of the
    same weighted correspondences: the RMS over the weighted ones of the
    difference of their float64 Sampson distances, pixels, where at least
    POSE_MIN_INLIERS are weighted.
    pair_pose_gap, parallax_gap (degrees): the pair's (R, t) against the
    float64 decomposition of its E over its inliers, and its parallax
    against the float64 parallax under that pose, where E has at least
    POSE_MIN_INLIERS inliers. bootstrap_pair_mismatch: passes whose
    bootstrap tries or kept pair differ from the reference's rule on the
    windowed graph's own counts, the guard's limits followed on the float64
    angles of the tries' poses. loop_pairs_mismatch: passes whose
    loop-closure pairs differ from the reference's rule on the full graph's
    counts. inject_gap: the share of the injected observations that the
    float64 gate rejects against the map they went into. finalize_cost_gap:
    finalize's reported cost against the float64 cost of the map it
    returned. pose_ate: the worst pass's trajectory error (scene units);
    infinite for a pass whose finalized map holds other cameras than the
    frames the run reports posed. unregistered: fed frames missing from
    their pass's finalized map.
    """
    inf = math.inf  # a run with nothing to check has shown nothing
    K = torch.as_tensor(sc.K, dtype=torch.float64)
    Kinv = torch.linalg.inv(K)
    focal = 0.5 * float(K[0, 0] + K[1, 1])
    thr = cfg.ransac.essential_threshold_px
    ratio = cfg.frontend.lowe_ratio
    k1, inl, fit, pose, par = [], [], [], [], []
    boot_bad = loop_bad = 0
    injected = rejected = 0
    costs, ates, unregistered = [], [], 0
    for pr in passes:
        for g, k in pr.checked:
            gr = pr.graphs[g]
            p = gr.pairs[k]
            m = p.matches
            k1.append(reference.k1_gap(p.f0.desc, p.f1.desc, p.f0.valid, p.f1.valid, ratio,
                                       m.idx1, m.valid))
            Kd = Kinv.to(p.E.device)
            n0 = rv.normalize(p.f0.xy[m.idx0.long()], Kd)
            n1 = rv.normalize(p.f1.xy[m.idx1.long()], Kd)
            ni = int(gr.graph.num_inliers[k])
            inl.append(rv.inlier_gap(ni, p.E, n0, n1, m.valid, focal, thr))
            if p.refit is not None and int((p.refit[1] > 0).sum()) >= POSE_MIN_INLIERS:
                fit.append(rv.solve_gap(p.refit[0], n0, n1, p.refit[1], focal))
            if ni >= POSE_MIN_INLIERS:
                R_ref, t_ref = rv.decompose(p.E, n0, n1, p.inliers)
                pose.append(rv.pose_gap(gr.graph.R[k], gr.graph.t[k], R_ref, t_ref))
                par.append(abs(float(gr.graph.parallax_deg[k])
                               - rv.parallax_deg(R_ref, n0, n1, p.inliers)))
        boot_bad += int(not bootstrap_sound(pr, guard))
        loop_bad += int(not loop_pairs_sound(pr, cfg))
        for r in pr.injects:
            i, rej = inject_counts(r, K)
            injected += i
            rejected += rej
        m = pr.map
        ncam = pr.cameras
        unregistered += pr.frames - min(ncam, len(pr.registered))
        costs.append(reference.relative_gap(
            float(pr.info["round1_cost"]),
            reference.reprojection_cost(m.poses, m.points, m.obs_uv, m.obs_mask, m.point_valid,
                                        m.cam_valid, K)))
        ate = None
        if ncam != len(pr.registered) or not bool(m.cam_valid[:ncam].all()):
            ate = inf  # cameras the reported frames do not account for
        elif ncam >= 3:
            ate = reference.ate(m.poses[:ncam].double().cpu().numpy(), sc.Rt[pr.registered])[0]
        if ate is not None:
            ates.append(ate)
            print(f"portbench: pass {pr.pass_id}: {pr.frames} frames, {ncam} cameras, "
                  f"bootstrap {pr.bootstrap_pair} after {len(pr.attempts)} tries, "
                  f"ATE {ate:.6f}", file=sys.stderr)
    print(f"portbench: {len(k1)} pairs checked, {injected} observations injected",
          file=sys.stderr)
    return {
        "k1_gap": max(k1, default=inf),
        "pair_inlier_gap": max(inl, default=inf),
        "essential_solve_gap": max(fit, default=inf),
        "pair_pose_gap": max(pose, default=inf),
        "parallax_gap": max(par, default=inf),
        "bootstrap_pair_mismatch": float(boot_bad) if passes else inf,
        "loop_pairs_mismatch": float(loop_bad) if passes else inf,
        "inject_gap": rejected / injected if injected else 0.0,
        "finalize_cost_gap": max(costs, default=inf),
        "pose_ate": max(ates, default=inf),
        "unregistered": float(unregistered) if passes else inf,
    }


def bootstrap_sound(pr: PassRecord, guard) -> bool:
    """The pass's bootstrap tries and kept pair are the reference rule's."""
    max_rot, max_dir, streams, pairs = guard
    g = pr.graphs[0].graph
    cands = rv.bootstrap_candidates(g.pair_i, g.pair_j, g.num_inliers, g.parallax_deg)
    tries = {(t.a, t.b, t.stream): t for t in pr.attempts}
    index = {(int(i), int(j)): k for k, (i, j) in enumerate(zip(g.pair_i, g.pair_j))}

    def disagreement(a, b, k):
        t = tries.get((a, b, k))
        if t is None or (a, b) not in index:
            return None
        x = index[(a, b)]
        p1 = t.pose1.double().cpu()
        return (rv.rotation_angle_deg(p1[:, :3], g.R[x]),
                rv.direction_angle_deg(p1[:, 3], g.t[x]))

    want = rv.guarded_bootstrap(cands, disagreement, max_rot, max_dir, streams, pairs)
    got = [(t.a, t.b, t.stream) for t in pr.attempts]
    return want is not None and want[0] == got and want[1] == tuple(pr.bootstrap_pair)


def loop_pairs_sound(pr: PassRecord, cfg) -> bool:
    """The pass's loop-closure pairs are the reference rule's on the full
    graph, each injected both ways."""
    if len(pr.graphs) < 2:
        return cfg.loop_close_pairs == 0
    g = pr.graphs[-1].graph
    want = rv.loop_pairs(g.pair_i, g.pair_j, g.num_inliers, cfg.loop_close_pairs)
    got = [(r.cam_i, r.cam_j) for r in pr.injects]
    return got == [d for i, j in want for d in ((i, j), (j, i))]


def inject_counts(r: InjectRecord, K) -> tuple:
    """(observations the call injected, of them those the float64 gate
    rejects): new cells of the camera's observation column, and cells
    already observed whose pixels it overwrote (rejected as not fresh)."""
    c = r.cam_j
    before, after = r.before, r.after
    was = before.obs_mask[:, c]
    new = after.obs_mask[:, c] & ~was
    moved = was & (after.obs_uv[:, c] != before.obs_uv[:, c]).any(-1)
    pids = torch.nonzero(new)[:, 0]
    rej = rv.inject_rejected(before.points, before.point_valid, was, before.poses[c],
                             K.to(before.points.device), pids, after.obs_uv[pids, c], r.gate_px)
    n_moved = int(moved.sum())
    return int(pids.numel()) + n_moved, rej + n_moved
