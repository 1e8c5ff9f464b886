"""Driver ``incremental``: bench.py's per-frame path, pass after pass.

A pass bootstraps on frames 0 and 1 (``init_from_bootstrap``, a generator
seeded from the run's seed and the pass), then registers each later frame
(``sift.detect_and_compute`` -> ``register_frame`` ->
``ba.bundle_adjust_map``), synchronized per frame, and the next pass
starts again from the bootstrap. Closed loop: one caller, the next frame
fed when the last one's pose and map are back. The window ends with the
frame that crosses ``--seconds``.

Traffic parameters: ``warmup_frames`` (frames of a throw-away pass run in
set-up), ``checked_share`` (the chance, drawn from the seed, that a
registered frame's maps before and after bundle adjustment are kept for
the reference; the window's last registered frame is always kept) and
``profile_seconds`` (the stretch at the end of a --trace 1 window under
torch.profiler). Every K1 call of the window is
kept for the reference: a call keeps references to its inputs and answers
(~2 MB of descriptors a frame), no copy.

``frame_ms_p95`` is the tail of the registered frames' latency (frames 2
and on); a pass's bootstrap (two detections and the two-view solve) is
reported apart, as ``bootstrap_ms.pass`` in the traced run.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from portbench import pipeline, reference
from portbench.harness import (K1Recorder, Outcome, Profiler, Spans, TraceData, power_limit_w,
                               seed_stream, sync, window_start)


def control_triangulate(P1, P2, pts1, pts2):
    """The reference's bfloat16 DLT in the place of the port's
    ``triangulation.triangulate_euclidean`` (the control)."""
    return reference.triangulate(P1, P2, pts1, pts2, torch.bfloat16).to(pts1.dtype)


def tiny(config: dict, traffic: dict):
    """The cell cut for the CPU tests: 7 frames of 240x160 over 18 deg, a
    map of 16 cameras and 4096 points, 2 warm-up frames, a 0.5 s stretch."""
    config = pipeline.tiny(config)
    config["scene"].update(num_cameras=7, arc_degrees=18.0)
    config["sfm"]["map"] = {"max_cameras": 16, "max_points": 4096}
    return config, dict(traffic, warmup_frames=2, profile_seconds=0.5)


def run(ctx) -> Outcome:
    ctx.log("start")
    import sfm_mvs_tpu_torch  # noqa: F401  (float32 products, TF32 off)
    from sfm_mvs_tpu_torch.ops import matching_cuda, triangulation

    tri_orig = triangulation.__dict__["triangulate_euclidean"]
    if ctx.control:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        triangulation.triangulate_euclidean = control_triangulate
    ctx.log("import")
    if ctx.device.type == "cuda":
        matching_cuda.build()
        ctx.log("K1 build")
    tr = ctx.traffic
    cfg = pipeline.sfm_config(ctx.config)
    sc = pipeline.render(ctx)
    stack8 = pipeline.stage_u8(sc.images)
    ctx.log("render")
    n = stack8.shape[0]
    spans = Spans(ctx.device, enabled=ctx.trace)
    rec = K1Recorder(control=ctx.control)
    runner = pipeline.SparseRunner(ctx, stack8, cfg, spans)

    for i in range(1, min(n, 1 + tr["warmup_frames"])):
        runner.step(0, i)
    sync(ctx.device)
    ctx.log("warm-up")
    spans.seconds.clear()
    runner.ba_event_ms.clear()
    window_start(ctx)
    setup_s = time.perf_counter() - ctx.t_start

    data = TraceData(spans=spans.seconds, counts={}) if ctx.trace else None
    prof = Profiler(ctx.device) if ctx.trace else None
    frames, passes, boot_ms = [], [], []
    t_win = time.perf_counter()
    deadline = t_win + ctx.seconds
    prof_at = deadline - tr["profile_seconds"]
    pass_id, done = 1, False
    rec.keep = True
    runner.last = None
    rng = seed_stream(ctx.seed, 5)
    while not done:
        last = 0
        for i in range(1, n):
            now = time.perf_counter()
            frame_s = max((f.latency_s for f in frames[-12:]), default=0.0)
            # The stretch: from prof_at, and at least the window's last frame, which
            # may take up to twice the recent frames' latency on a loaded host.
            if prof is not None and prof.prof is None and (now >= prof_at
                                                           or now + 2 * frame_s >= deadline):
                prof.start()
                spans.profiling = rec.log_shapes = True
            runner.keep = i > 1 and rng.random() < tr["checked_share"]
            frames.append(runner.step(pass_id, i))
            if i == 1 and (prof is None or prof.prof is None):
                boot_ms.append(frames[-1].latency_s * 1e3)
            last = i
            if time.perf_counter() >= deadline:
                done = True
                break
        passes.append(runner.record(pass_id, last + 1))
        pass_id += 1
    window_s = time.perf_counter() - t_win
    rec.keep = runner.keep = False
    if runner.last is not None and (not runner.kept or runner.kept[-1] is not runner.last):
        runner.kept.append(runner.last)  # the window's last registered frame is always checked
    triangulation.triangulate_euclidean = tri_orig

    if prof is not None:
        if prof.prof is not None:  # a window too short to reach the stretch has no trace
            prof.stop(data)
        spans.profiling = rec.log_shapes = False
        data.k1_launches = rec.launch_shapes()
        data.counts["ba_events"] = runner.ba_event_ms
        data.counts["bootstrap_ms"] = boot_ms
        data.power_limit_w = power_limit_w() if ctx.device.type == "cuda" else None

    produced = sum(2 if f.frame == 1 else 1 for f in frames)
    lat_ms = np.array([f.latency_s for f in frames if f.frame > 1]) * 1e3
    end_to_end = {"frames_per_s": produced / window_s,  # no registered frame: no tail
                  "frame_ms_p95": float(np.percentile(lat_ms, 95)) if lat_ms.size else None}
    accepted = torch.stack([f.accepted for f in frames]).cpu().numpy()
    kept, maps = rec.kept, runner.kept
    state = {"runner": runner, "stack8": stack8, "images": sc.images}

    def free():
        rec.close()
        state.clear()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge() -> dict:
        return readings(kept, passes, maps, sc)

    return Outcome(setup_s=setup_s, attempted=produced,
                   failed=int((~accepted).sum()), end_to_end=end_to_end, trace=data,
                   free=free, judge=judge)


def readings(kept, passes, maps, sc) -> dict:
    """The numbers compared against the cell's limits.

    k1_gap: the worst K1 answer of the window's calls against the float64
    reference (``reference.k1_gap``). unregistered: frames the window fed
    whose camera is missing from their pass's map. pose_ate: the worst
    pass's absolute trajectory error (similarity-aligned camera centres,
    scene units) against the rendered poses. ba_cost_gap: the worst pass's
    relative gap between the last bundle adjustment's reported cost and
    the reference's float64 cost of the map it returned. The rest are the
    worst over the frames kept for the reference: ba_descent, the float64
    cost of the map bundle adjustment returned over that of the map it
    received; tri_gap, the points register_frame triangulated against the
    float64 DLT of their two observations under the frame's poses
    (``reference.tri_gap``).
    """
    out = {"k1_gap": max((reference.k1_gap(d0, d1, v0, v1, r, m.idx1, m.valid)
                          for d0, d1, v0, v1, r, m in kept), default=math.inf)}
    unregistered, ates, gaps = 0, [], []
    K = sc.K
    for pr in passes:
        m = pr.map
        cam_valid = m.cam_valid.cpu().numpy()
        ncam = int(cam_valid.sum())
        unregistered += max(pr.frames - ncam, 0)
        if ncam >= 3:
            poses = m.poses[:ncam].double().cpu().numpy()
            ates.append(reference.ate(poses, sc.Rt[:ncam])[0])
            print(f"portbench: pass {pr.pass_id}: {pr.frames} frames, {ncam} cameras, "
                  f"ATE {ates[-1]:.6f}", file=sys.stderr)
        if pr.ba_cost is not None:
            ref = reference.reprojection_cost(m.poses, m.points, m.obs_uv, m.obs_mask,
                                              m.point_valid, m.cam_valid, K)
            gaps.append(reference.relative_gap(float(pr.ba_cost), ref))
    out["unregistered"] = float(unregistered)
    out["pose_ate"] = max(ates, default=math.inf)
    out["ba_cost_gap"] = max(gaps, default=math.inf)
    out.update(frame_readings(maps, sc))
    return out


def frame_readings(maps, sc) -> dict:
    """ba_descent and tri_gap over the kept frames."""
    K = torch.as_tensor(sc.K, dtype=torch.float64)
    descent, tri = [], []
    for fm in maps:
        m, a = fm.registered, fm.adjusted
        K = K.to(m.points.device)
        before = reference.reprojection_cost(m.poses, m.points, m.obs_uv, m.obs_mask,
                                             m.point_valid, m.cam_valid, K)
        after = reference.reprojection_cost(a.poses, a.points, a.obs_uv, a.obs_mask,
                                            a.point_valid, a.cam_valid, K)
        descent.append(after / max(before, 1e-30))
        cb = int(m.num_cams) - 1
        p0, p1 = int(fm.points_before), int(m.num_points)
        if cb != fm.frame or p1 <= p0:  # the frame was not registered, or made no point
            continue
        idx = torch.arange(p0, p1, device=m.points.device)
        idx = idx[(m.obs_mask[idx][:, [cb - 1, cb]] & m.point_valid[idx, None]).all(1)]
        poses = m.poses.double()
        center = reference.camera_centers(poses[cb:cb + 1].cpu().numpy())[0]
        tri.append(reference.tri_gap(m.points[idx], K @ poses[cb - 1], K @ poses[cb],
                                     m.obs_uv[idx, cb - 1], m.obs_uv[idx, cb],
                                     torch.as_tensor(center, device=K.device)))
    print(f"portbench: {len(maps)} frames checked: ba_descent {min(descent, default=0):.6f} to "
          f"{max(descent, default=0):.6f} (mean {np.mean(descent) if descent else 0:.6f}), "
          f"tri_gap to {max(tri, default=0):.3e}", file=sys.stderr)
    none = math.inf  # a run with no checked frame has nothing to show
    return {"ba_descent": max(descent, default=none), "tri_gap": max(tri, default=none)}
