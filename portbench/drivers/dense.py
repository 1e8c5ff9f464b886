"""Driver ``dense``: plane-sweep MVS over a calibrated set, call after call.

Set-up renders the views, reconstructs them with bench.py's per-frame
loop (bootstrap, then detect -> register_frame -> global BA per view) and
polishes the map with ``refine.finalize_map``. The window calls
``mvs.densify_map`` over every view as reference, again and again, one
caller, closed loop; each call's frames carry a gain drawn from the seed,
so no call gets the inputs of another. Only whole calls count: the window
ends when the call that crosses ``--seconds`` returns.

Traffic parameters: ``gain`` ([low, high] of the per-call gain),
``warmup_calls``, ``checked_share`` (the chance, drawn from the seed, that
a call's outputs are kept for the reference; the last call is always
kept), ``checked_views`` (views of each kept call, drawn from the seed
when the call is kept, whose pass-1 and pass-2 maps the reference
recomputes) and ``profile_seconds`` (the stretch at the end of a --trace 1
window under torch.profiler).

A kept call keeps on the card only what the reference reads: its cloud
(on the host, as the call returns it), its filtered, fused depth and
valid maps (every view's: the depth and cloud checks read them all), and
for each checked view its pass-1 depth, confidence and valid maps with
the pass-1 depths of its geometric neighbours, gathered into tensors of
their own (a few device copies; no host copy inside the window).
"""

from __future__ import annotations

import math
import sys
import time

import torch

from portbench import pipeline, reference
from portbench.harness import (Outcome, Profiler, Spans, TraceData, power_limit_w, seed_stream,
                               sync, window_start)

# Fused depths of one pixel "agree" within this share of the reference's.
FUSE_REL = 1e-3


class SweepRecorder:
    """Wraps the port's pass-1 entry (``mvs._plane_sweep_batch``) for the
    run: keeps each batch's maps while ``keep`` is set (references, no
    copy), and in the control puts the reference's bfloat16 sweep in its
    place."""

    def __init__(self, mvs, sweep: dict, control: bool):
        self.mvs, self.sweep, self.control = mvs, sweep, control
        self.orig = mvs.__dict__["_plane_sweep_batch"]
        self.keep = False
        self.kept: list = []
        mvs._plane_sweep_batch = self._call

    def _call(self, ref_b, nbr_b, pose_b, nposes_b, K, lo_b, hi_b, num_depths=64, **kw):
        if self.control:
            sweep = dict(self.sweep, num_depths=num_depths)
            maps = [reference.plane_sweep(ref_b[b], nbr_b[b], pose_b[b], nposes_b[b], K,
                                          float(lo_b[b]), float(hi_b[b]), sweep, torch.bfloat16)
                    for b in range(ref_b.shape[0])]
            out = self.mvs.DepthMap(*[torch.stack([m[k] for m in maps]).to(
                torch.float32 if k < 2 else torch.bool) for k in range(3)])
        else:
            out = self.orig(ref_b, nbr_b, pose_b, nposes_b, K, lo_b, hi_b,
                            num_depths=num_depths, **kw)
        if self.keep:
            self.kept.append(out)
        return out

    def take(self) -> list:
        """The batches of the call kept last."""
        kept, self.kept = self.kept, []
        return kept

    def close(self):
        self.mvs._plane_sweep_batch = self.orig


def slot_of(batches, v: int):
    """(pass-1 batch, slot) of the call's v-th swept slot, or None past the
    last slot."""
    for dm in batches:
        if v < dm.depth.shape[0]:
            return dm, v
        v -= dm.depth.shape[0]
    return None


def checked_call(g, pts, dms, batches, views, geo_k: int, n: int):
    """What the reference reads of one kept call: (gain, cloud, [(view,
    fused depth, fused valid)] for every view, {checked view: (pass-1
    depths of the view and its geometric neighbours (1 + k, H, W), its
    confidence, its valid map), or None where the call swept no slot for
    one of them})."""
    fused = [(r, dm.depth, dm.valid) for r, dm in sorted(dms.items())]
    p1 = {}
    for r in views:
        need = [slot_of(batches, v) for v in [r] + reference.geo_neighbors(r, n, geo_k)]
        if any(s is None for s in need):
            p1[r] = None
            continue
        (dm, j) = need[0]
        p1[r] = (torch.stack([b.depth[i] for b, i in need]), dm.confidence[j].clone(),
                 dm.valid[j].clone())
    return g, pts, fused, p1


def tiny(config: dict, traffic: dict):
    """The cell cut for the CPU tests: 6 views of 240x160 over 12 deg, a map
    of 6 cameras and 4096 points, 16 depths, a 0.5 s stretch."""
    config = pipeline.tiny(config)
    config["scene"].update(num_cameras=6, arc_degrees=12.0)
    config["sfm"]["map"] = {"max_cameras": 6, "max_points": 4096}
    config["mvs"]["num_depths"] = 16
    return config, dict(traffic, profile_seconds=0.5)


def control_fuse(depth_b, conf_b, valid_b, pose_b, nbr_depth_b, nbr_pose_b, nbr_valid_b,
                 min_cons_b, K, color_b, rel_tol, stride: int = 2, **kw):
    """The reference's bfloat16 pass 2 (filter, fusion, back-projection) in
    the place of the port's ``_fuse_batch`` (the control)."""
    settings = dict(geo_rel_tol=rel_tol, free_space_rel=kw["free_space_rel"],
                    min_conf=kw["min_conf"], edge_trim_rel=kw["edge_trim_rel"],
                    edge_trim_radius=kw["edge_trim_radius"], edge_keep_conf=kw["edge_keep_conf"])
    pts, oks, vals, deps = [], [], [], []
    for b in range(depth_b.shape[0]):
        nv = nbr_valid_b[b]
        d, keep = reference.consistency(depth_b[b], conf_b[b], valid_b[b], pose_b[b],
                                        nbr_depth_b[b][nv], nbr_pose_b[b][nv], K, settings,
                                        int(min_cons_b[b]), dtype=torch.bfloat16)
        pts.append(reference.grid_points(d, pose_b[b], K, stride, "bf16").float())
        oks.append(keep[::stride, ::stride].reshape(-1))
        vals.append(keep)
        deps.append(d.float())
    cols = color_b[:, ::stride, ::stride]
    cols = (cols[..., None].expand(*cols.shape, 3) * 255.0 if cols.dim() == 3 else cols)
    return (torch.stack(pts), cols.reshape(depth_b.shape[0], -1, 3).float(), torch.stack(oks),
            torch.stack(vals), torch.stack(deps))


def run(ctx) -> Outcome:
    ctx.log("start")
    import sfm_mvs_tpu_torch  # noqa: F401  (float32 products, TF32 off)
    from sfm_mvs_tpu_torch.models import mvs, refine
    from sfm_mvs_tpu_torch.ops import matching_cuda

    if ctx.control:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    ctx.log("import")
    if ctx.device.type == "cuda":
        matching_cuda.build()
        ctx.log("K1 build")
    tr, conf = ctx.traffic, ctx.config
    cfg = pipeline.sfm_config(conf)
    sc = pipeline.render(ctx)
    stack8 = pipeline.stage_u8(sc.images)
    ctx.log("render")
    n = stack8.shape[0]
    spans = Spans(ctx.device, enabled=False)
    runner = pipeline.SparseRunner(ctx, stack8, cfg, spans)
    for i in range(1, n):
        runner.step(0, i)
    state, _ = refine.finalize_map(runner.pstate.map, **conf["finalize"])
    ctx.log("sparse reconstruction")
    runner = None
    grays = [pipeline.gray_of(stack8, i) for i in range(n)]
    bgrs = [pipeline.bgr_of(stack8, i) for i in range(n)]
    settings = dict(conf["mvs"])
    rng = seed_stream(ctx.seed, 4)
    rec = SweepRecorder(mvs, conf["mvs_pass1"], ctx.control)
    fuse_orig = mvs.__dict__["_fuse_batch"]
    if ctx.control:
        mvs._fuse_batch = control_fuse

    def call(g):
        return mvs.densify_map([x * g for x in grays], state, images_bgr=[x * g for x in bgrs],
                               return_depth_maps=True, **settings)

    call_s = 0.0
    for _ in range(tr["warmup_calls"]):
        t_call = time.perf_counter()
        call(float(rng.uniform(*tr["gain"])))
        sync(ctx.device)
        call_s = time.perf_counter() - t_call
    ctx.log("warm-up")
    window_start(ctx)
    setup_s = time.perf_counter() - ctx.t_start

    data = TraceData(spans=spans.seconds, counts={}) if ctx.trace else None
    prof = Profiler(ctx.device) if ctx.trace else None
    if ctx.trace:
        spans.enabled = True
        spans.wrap(mvs, "_depth_ranges", "mvs_sweep")
        spans.wrap(mvs, "_plane_sweep_batch", "mvs_sweep")
        spans.wrap(mvs, "_fuse_batch", "mvs_fuse")
    mv = conf["mvs"]
    geo_k = max(mv["num_neighbors"], mv["geo_num_neighbors"])

    def draw():
        return [int(v) for v in rng.choice(n, size=tr["checked_views"], replace=False)]

    kept, views, views_timed, last, last_kept = [], 0, 0, None, False
    t_win = time.perf_counter()
    deadline = t_win + ctx.seconds
    prof_at = deadline - tr["profile_seconds"]
    while True:
        t_call = time.perf_counter()
        # The stretch: from prof_at, and at least the window's last call, which
        # may take up to twice the last call's time on a loaded host.
        if (prof is not None and prof.prof is None
                and (t_call >= prof_at or t_call + 2 * call_s >= deadline)):
            prof.start()
            spans.profiling = True
        keep = rng.random() < tr["checked_share"]
        g = float(rng.uniform(*tr["gain"]))
        rec.keep, rec.kept = True, []
        with spans.outer("densify"):
            pts, _, dms = call(g)
        views += len(dms)
        if prof is None or prof.prof is None:
            views_timed += len(dms)
        call_s = time.perf_counter() - t_call
        last, last_kept = (g, pts, dms, rec.take()), keep
        if keep:
            kept.append(checked_call(*last, draw(), geo_k, n))
        if time.perf_counter() >= deadline:
            break
    sync(ctx.device)
    window_s = time.perf_counter() - t_win
    rec.keep = False
    if prof is not None:
        if prof.prof is not None:  # a window too short to reach the stretch has no trace
            prof.stop(data)
        spans.profiling = False
        spans.unwrap_all()
        data.counts["views"] = views_timed
        data.power_limit_w = power_limit_w() if ctx.device.type == "cuda" else None
    if not last_kept:
        kept.append(checked_call(*last, draw(), geo_k, n))
    del last, dms, pts
    rec.close()
    mvs._fuse_batch = fuse_orig

    sparse = (state.points.clone(), state.point_valid.clone(), state.poses[:n].clone())
    refs = {"state": state, "grays": grays, "bgrs": bgrs, "images": sc.images}
    del state, grays, bgrs

    def free():
        refs.clear()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge() -> dict:
        return readings(kept, sparse, stack8, sc, conf)

    return Outcome(setup_s=setup_s, attempted=views, failed=0,
                   end_to_end={"dense_views_per_s": views / window_s}, trace=data,
                   free=free, judge=judge)


def readings(checks, sparse, stack8, sc, conf) -> dict:
    """The numbers compared against the cell's limits, the worst over the
    checked calls.

    pose_ate: the set-up reconstruction's trajectory error (the start the
    sweep takes its poses and depth ranges from) against the rendered poses.
    sweep_mismatch: per checked view, the share of pixels on which pass 1's
    depth and valid maps disagree with the float64 reference sweep of the
    call's own images (``reference.plane_sweep``). fuse_mismatch: per
    checked view, the share on which pass 2's filtered, fused maps disagree
    with the float64 reference filter of pass 1's maps
    (``reference.consistency``). depth_rel_rms, depth_median: the filtered,
    fused depth maps' relative error against the rendered depths, after the
    scale of the reconstruction's similarity to the rendered trajectory.
    depth_uncovered: the share of rendered pixels without a depth.
    cloud_gap: the fused cloud's largest distance from the reference's
    back-projection of those depth maps, as a share of depth (+inf where
    the counts differ).
    """
    points, point_valid, poses = sparse
    n = poses.shape[0]
    mv, p1 = conf["mvs"], dict(conf["mvs_pass1"], num_depths=conf["mvs"]["num_depths"])
    ate, (s, _, _) = reference.ate(poses.double().cpu().numpy(), sc.Rt[:n])
    gt = sc.depths.cpu().numpy()
    ranges = reference.depth_ranges(points, point_valid, poses)
    out = {"pose_ate": ate, "sweep_mismatch": 0.0, "fuse_mismatch": 0.0, "depth_rel_rms": 0.0,
           "depth_median": 0.0, "depth_uncovered": 0.0, "cloud_gap": 0.0}
    geo_k = max(mv["num_neighbors"], mv["geo_num_neighbors"])
    for g, pts, dmaps, pass1 in checks:
        got = {}
        host = [(r, d.cpu().numpy(), v.cpu().numpy()) for r, d, v in dmaps]
        missing = n - len(host)
        rms, med, unc = reference.depth_errors(host, gt, s)
        got["depth_rel_rms"], got["depth_median"] = rms, med
        got["depth_uncovered"] = (unc * len(host) + missing) / n
        got["cloud_gap"] = reference.cloud_gap(pts, dmaps, poses, sc.K, mv["stride"])
        fused = {r: (d, v) for r, d, v in dmaps}
        sweep_bad = fuse_bad = 0.0
        for r, maps in pass1.items():
            if maps is None:  # a view the call did not sweep
                sweep_bad = fuse_bad = math.inf
                continue
            p1_depth, p1_conf, p1_valid = maps
            gn = reference.geo_neighbors(r, n, geo_k)
            nb = reference.sweep_neighbors(r, n, mv["num_neighbors"])
            imgs = torch.stack([pipeline.gray_of(stack8, i) * g for i in [r] + nb])
            lo, hi = ranges[r]
            ref_d, _, ref_v = reference.plane_sweep(imgs[0], imgs[1:], poses[r], poses[nb], sc.K,
                                                    lo, hi, p1)
            step = (1 / lo - 1 / hi) / max(p1["num_depths"] - 1, 1) / 2 ** p1["coarse_levels"]
            sw = reference.sweep_mismatch((p1_depth[0], p1_valid), (ref_d, ref_v), step,
                                          sc.depths[r] > 0.1)
            ref2 = reference.consistency(p1_depth[0], p1_conf, p1_valid, poses[r],
                                         p1_depth[1:], poses[gn], sc.K, mv,
                                         min(mv["geo_min_consistent"], len(gn)))
            fu = reference.fuse_mismatch(fused.get(r, (ref2[0], ~ref2[1])), ref2, FUSE_REL)
            print(f"portbench: gain {g:.4f} view {r}: sweep_mismatch {sw:.6e}, "
                  f"fuse_mismatch {fu:.6e}", file=sys.stderr)
            sweep_bad, fuse_bad = max(sweep_bad, sw), max(fuse_bad, fu)
        got["sweep_mismatch"], got["fuse_mismatch"] = sweep_bad, fuse_bad
        for k, v in got.items():
            out[k] = max(out[k], v if not math.isnan(v) else math.inf)
    return out
