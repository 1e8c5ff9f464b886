"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the check
    python3 chip_smoke.py --profile    # the check, then where a frame's time goes

Phases, each printing one line (any failure exits non-zero):

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles the port's CUDA sources (csrc/*.cu) with nvcc; the tile
   kernel's registers and spill bytes from the ptxas report (spills fail).
3. K1: the 2-NN matcher kernel against its plain PyTorch version on the
   card, on nine cases (five of PR 1; exact ties across tiles and across
   splits, where d1 == d2 bitwise at the lower column; train sets of 1 and
   100 columns), then the kernel, the plain version and ``torch.mm`` of the
   cross term (the library yardstick) timed at 4096 x 4096 x 128 in turns,
   launch-amortized (50 back-to-back calls between CUDA events, median of 5
   windows), beside the FP32-FMA bound; the device ops of one call counted
   under torch.profiler (at most 6).
4. main path: ``IncrementalSfM(cfg, device="cuda").run(images)`` on the
   57-frame 968x648 staircase scene at bench.py's frontend settings, BA off;
   checks registration, ATE and reprojection error against ground truth,
   and that the run went through the kernel (its launch counter).
5. bench path: bench.py's per-frame-BA path on the same frames (frames
   staged as uint8, bootstrap, then detect -> register_frame -> global
   ``ba.bundle_adjust_map(max_iterations=8, cg_iters=15)`` per frame), then
   the densification sweep (``redetect_for_sweep`` + ``finalize_with_sweep``
   grown to 65,536 points, strides 1 and 2); checks 57/57 cameras, ATE below
   0.05 and below phase 4's, sub-pixel reprojection and BA rms, at least
   15,000 finite points at sub-pixel rms after the sweep, and 167 K1
   launches (1 bootstrap + 55 frames + 56 + 55 swept pairs).
6. driver with BA: ``IncrementalSfM(cfg, device="cuda")`` on the same
   frames with ``BaConfig(enabled=True, max_iterations=8)``, then
   ``finalize()`` with the same sweep (compaction, shrink, track remap,
   ``finalize_map``, sweep); checks 57/57 cameras, ATE below 0.05 and
   below phase 4's, sub-pixel reprojection, a final cost below 1 px^2,
   ATE after finalize below 0.05, at least 15,000 finite points and 167
   K1 launches.
7. CLI: the frames written as 8-bit PNGs, then the port's ``cli.main`` in
   this process with ``--bootstrap auto --ba --finalize --sweep --densify``
   on the card; checks the outputs (57/57 poses in pose.csv at ATE < 0.05,
   >= 15,000 map points after finalize with at least half of them kept by
   sparse.ply's cleaning, >= 1,000,000 finite dense vertices, the metrics
   events) and that every match went through K1 (view-graph pairs +
   bootstrap + registrations + swept pairs); prints each stage's wall.
8. resume: the CLI with ``--bootstrap seq --checkpoint-every 20``, then
   again with ``--resume`` from frame 40 into the same output; the two
   pose.csv files must be equal byte for byte.
9. MVS against ground truth (benchmarks/mvs_full.py's recipe): phase 5's
   map before its sweep, ``refine.finalize_map(max_iterations=20)``, then
   ``mvs.densify_map`` with the GT harness's settings; checks depth
   relative error (median < 0.01, RMS < 0.03), coverage of GT-valid pixels
   > 0.65 and finite points, beside the v5e quality record.
10. loop closure (runs between phases 7 and 8, on the same PNGs): the CLI
    with ``--bootstrap seq --essential-solver 5pt --grad-sampling bilinear
    --ba --loop-close 4 --finalize``; checks 57 poses at ATE < 0.05, the
    finalize event's loop-closure observations (> 0), merged points and
    robust cost, a finalize cost below 1 px^2, and K1 launches = bootstrap
    + registrations + the 1596-pair view graph + 2 per loop pair.
11. BA of the intrinsics: the staircase rendered with radial distortion
    (-0.18, 0.03), the driver unaware of it (BA off), then
    ``ba.bundle_adjust_map_intrinsics(max_iterations=40, cg_iters=30)``
    (k1 < 0 within 50% of -0.18, cost halved, ATE improved) and
    ``bundle_adjust_map_percam_intrinsics`` (cost not raised, finite rows,
    camera 0's row exactly [1, 0, 0]); 56 K1 launches.
12. --pipeline global: an 11-view textured plane at 968x648,
    ``GlobalSfM(cfg, device="cuda").run`` (11/11 cameras, > 100 points,
    global BA cost < 4 px^2), ``final_sweep`` (the map grows), then the
    CLI with ``--pipeline global --finalize`` (rc 0, 11 poses); K1
    launches = 2 x (10 pairs + 10 swept pairs).
13. the last line: {"ok": true, "device": {...}}.

``--profile`` adds, after phase 9, torch.profiler over one
``mvs._plane_sweep_batch`` call of 4 reference frames.

    python3 chip_smoke.py --microbench  # only the card's limits behind K1

builds ``csrc/microbench.cu`` and prints the FFMA rate (independent
chains; an 8x8 outer product from registers), the SM cycles of a warp's
float4 shared load by address pattern, and the SM cycles to copy a
2048-float chunk with 4-byte (transposing) or 16-byte ``cp.async``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

# Margins for kernel-vs-plain agreement. The kernel sums q.t with FP32 FMA
# in another order than cuBLAS, so distances agree to rounding (atol), and
# decisions (argmin, ratio test) are compared only where the plain
# version's margin exceeds that rounding.
DIST_ATOL = 1e-5
MARGIN = 1e-5
DEVICE = torch.device("cuda")


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} python {sys.version.split()[0]}")
    return smi


def phase_build():
    """Compile csrc/knn2.cu; returns (seconds, registers, spill bytes) of
    the tile kernel from the ptxas report."""
    from sfm_mvs_tpu_torch.ops import matching_cuda

    t0 = time.time()
    path = matching_cuda.build()
    secs = time.time() - t0
    report = [ln.strip() for ln in matching_cuda.build_log.splitlines()
              if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    log(f"[build] csrc/knn2.cu -> {path.name} in {secs:.1f}s; " + " | ".join(report))
    registers = spills = None
    in_tile = False
    for ln in report:
        if "Compiling entry" in ln:
            in_tile = "knn2_tile_kernel" in ln
        elif in_tile and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            spills = int(m.group(1)) + int(m.group(2))
        elif in_tile and "Used" in ln:
            registers = int(re.search(r"Used (\d+) registers", ln).group(1))
    if registers is None or spills is None:
        raise AssertionError("no ptxas report for knn2_tile_kernel")
    if spills:
        raise AssertionError(f"knn2_tile_kernel spills {spills} bytes")
    return secs, registers, spills


def _descs(rng, n, d=128):
    x = rng.random((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _k1_cases(real_pair):
    """(name, desc0, desc1, valid0, valid1, ratio, tie) as numpy arrays; `tie`
    is None or (column offset of the duplicates, each query's source column)."""
    rng = np.random.default_rng(0)
    cases = []
    d0 = _descs(rng, 300)
    d1 = d0[rng.permutation(300)] + 0.01 * rng.standard_normal((300, 128)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    cases.append(("300x300", d0, d1, np.ones(300, bool), np.ones(300, bool), 0.7, None))
    d0 = _descs(rng, 100)
    d1 = np.vstack([_descs(rng, 500), d0[:100]]).astype(np.float32)
    cases.append(("100x600", d0, d1, np.ones(100, bool), np.ones(600, bool), 0.8, None))
    d0 = _descs(rng, 64)
    d1 = np.vstack([d0[:32], d0[:32]]).astype(np.float32)
    cases.append(("invalid-masks", d0, d1, np.arange(64) < 40, np.arange(64) < 32, 0.7, None))
    d0 = _descs(rng, 4095)
    d1 = np.vstack([d0[rng.permutation(4095)][:2048]
                    + 0.02 * rng.standard_normal((2048, 128)).astype(np.float32),
                    _descs(rng, 2049)]).astype(np.float32)
    v1 = rng.random(4097) > 0.05
    cases.append(("4095x4097", d0, d1, rng.random(4095) > 0.05, v1, 0.75, None))
    cases.append(real_pair + (None,))
    # Exact ties: train rows duplicated bit for bit `off` columns apart, in
    # another 128-column tile (off 128) or another split (off 2048); each
    # query is a noisy copy of a duplicated row, whose lower column must win.
    for name, off in (("ties-across-tiles", 128), ("ties-across-splits", 2048)):
        d1 = _descs(rng, 4096)
        lower = np.arange(4096)[(np.arange(4096) // off) % 2 == 0]
        d1[lower + off] = d1[lower]
        src = rng.choice(lower, 4096)
        d0 = d1[src] + 0.01 * rng.standard_normal((4096, 128)).astype(np.float32)
        d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
        cases.append((name, d0, d1, np.ones(4096, bool), np.ones(4096, bool), 0.75,
                      (off, src)))
    # Small train sets: one column (no second candidate: d2 = 3e38) and 100
    # (one ragged tile).
    for n1 in (1, 100):
        d1 = _descs(rng, n1)
        d0 = d1[rng.integers(0, n1, 4096)] + 0.05 * rng.standard_normal((4096, 128)).astype(
            np.float32)
        d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
        cases.append((f"small-train-4096x{n1}", d0, d1, rng.random(4096) > 0.05,
                      np.ones(n1, bool), 0.75, None))
    return cases


def _window_ms(fn, calls=50, windows=5):
    """Launch-amortized time: `calls` back-to-back calls between two CUDA
    events, elapsed / calls; one value per window."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return out


def _check_k1_case(case, matching, matching_cuda):
    """One case: kernel against the plain version; returns max |dd|."""
    name, d0, d1, v0, v1, ratio, tie = case
    t = [torch.as_tensor(a, device=DEVICE) for a in (d0, d1, v0, v1)]
    kd1, kj1, kd2 = matching_cuda.knn2_raw(t[0], t[1], t[3])
    pd1, pj1, pd2 = matching.top2(matching.distance_matrix(t[0], t[1], t[3]))
    km = matching_cuda.knn_match_cuda(*t, ratio=ratio)
    pm = matching.knn_match(*t, ratio=ratio)
    torch.cuda.synchronize()
    # Compared on valid query rows: an invalid SIFT slot may carry a NaN
    # descriptor, whose row neither version ever reports as a match.
    q = t[2]
    err = max(float((kd1 - pd1)[q].abs().max()), float((kd2 - pd2)[q].abs().max()))
    decided = (pd2 - pd1) > MARGIN
    r2d2 = (ratio * ratio) * pd2
    clear = (pd1 - r2d2).abs() > MARGIN
    n_idx = int((q & decided & (kj1 != pj1.to(torch.int32))).sum())
    n_val = int((clear & (km.valid != pm.valid)).sum())
    n_inside = int((q & (~decided | ~clear)).sum())
    same = torch.equal(km.idx1, kj1) and torch.equal(
        km.idx0, torch.arange(len(v0), dtype=torch.int32, device=DEVICE))
    extra = ""
    bad = not same
    if tie is not None:
        # Bitwise: both duplicates give the same distance, the lower column wins.
        src = torch.as_tensor(tie[1], device=DEVICE)
        n_tie = int(((kd1 == kd2) & (kj1 == src)).sum())
        extra = f" exact_ties={n_tie}/{len(v0)} (d1 == d2 bitwise at the lower column)"
        bad |= n_tie != len(v0)
    if d1.shape[0] == 1:
        n_big = int((kd2 == matching.BIG).sum())
        extra = f" d2_is_3e38={n_big}/{len(v0)}"
        bad |= n_big != len(v0) or not bool((pd2 == matching.BIG).all())
    log(f"[k1] {name}: max|dd|={err:.3g} over {int(q.sum())} valid queries, "
        f"idx_mismatch={n_idx} valid_mismatch={n_val} inside_margin={n_inside} "
        f"matches={int(pm.valid.sum())}/{len(v0)}{extra}")
    if bad or not err <= DIST_ATOL or n_idx or n_val or bool((km.valid & ~q).any()):
        raise AssertionError(f"K1 disagrees with its plain version on {name}")
    return err


def k1_bound_ms(n0, n1, d):
    """(ms, bound_by): the least time of one call on an H100 SXM: the cross
    term's 2 n0 n1 d FP32 operations at 67 TFLOP/s (CUDA cores; the tensor
    cores have no FP32 mode), or its bytes (descriptors and masks read
    once; idx0, idx1 and valid written once) at 3.35 TB/s."""
    ops_ms = 2.0 * n0 * n1 * d / 67e12 * 1e3
    bytes_ms = ((n0 + n1) * (4 * d + 1) + n0 * 9) / 3.35e12 * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_k1(real_pair):
    """K1 against its plain version on every case, then the real pair timed
    launch-amortized in turns (plain, kernel, library, kernel, plain), the
    device ops of one call counted under torch.profiler."""
    from sfm_mvs_tpu_torch.ops import matching, matching_cuda

    worst = max(_check_k1_case(c, matching, matching_cuda) for c in _k1_cases(real_pair))

    name, d0, d1, v0, v1, ratio = real_pair
    t = [torch.as_tensor(a, device=DEVICE) for a in (d0, d1, v0, v1)]
    fns = {"plain": lambda: matching.knn_match(*t, ratio=ratio),
           "kernel": lambda: matching_cuda.knn_match_cuda(*t, ratio=ratio),
           "library": lambda: torch.mm(t[0], t[1].T)}
    windows = {k: [] for k in fns}
    turns = []
    for key in ("plain", "kernel", "library", "kernel", "plain"):
        w = _window_ms(fns[key])
        windows[key] += w
        turns.append(f"{key} {statistics.median(w):.4f}")
    ms = {k: statistics.median(v) for k, v in windows.items()}
    # Host enqueue rate of the wrapper (no synchronize inside the loop).
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(50):
        fns["kernel"]()
    host_ms = (time.perf_counter() - h0) / 50 * 1e3
    torch.cuda.synchronize()
    _, busy, n_ops, prof = _profile_window(fns["kernel"])
    kernel_us = {e.key: e.device_time_total for e in prof.key_averages() if "knn2" in e.key}
    n0, dd = d0.shape
    bound, bound_by = k1_bound_ms(n0, d1.shape[0], dd)
    log(f"[k1] time at {n0}x{d1.shape[0]}x{dd} (ms per call, CUDA events around 50 "
        f"back-to-back calls, median of 5 windows per turn): " + ", ".join(turns))
    log(f"[k1] kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, torch.mm cross term "
        f"{ms['library']:.4f} ms (TF32 off: {not torch.backends.cuda.matmul.allow_tf32}); "
        f"bound {bound:.4f} ms ({bound_by}), share {bound / ms['kernel']:.3f}; host enqueue "
        f"{host_ms:.4f} ms per call")
    log(f"[k1] one knn_match_cuda call under torch.profiler: {n_ops} device ops, device busy "
        f"{busy:.4f} ms; " + ", ".join(f"{k.split('(')[0]} {v / 1e3:.4f} ms"
                                         for k, v in kernel_us.items()))
    if n_ops > 6:
        raise AssertionError(f"one knn_match_cuda call launched {n_ops} device ops, expected <= 6")
    return dict(max_abs_err=worst, ms=ms["kernel"], plain_ms=ms["plain"],
                library_ms=ms["library"], bound_ms=bound, bound_by=bound_by,
                bound_share=bound / ms["kernel"], device_ops_per_call=n_ops)


SCENE = dict(num_cameras=57, image_size=(968, 648), focal=1200.0, radius=9.0,
             arc_degrees=50.0, num_strips=10, depth_spread=2.0)


def main_config():
    """bench.py's scene and frontend settings, bundle adjustment off (the
    CLI default)."""
    from sfm_mvs_tpu_torch.utils.config import (
        FrontendConfig, MapConfig, RansacConfig, SfmConfig,
    )

    W, H = SCENE["image_size"]
    f = SCENE["focal"]
    return SfmConfig(
        fx=f, fy=f, cx=W / 2.0, cy=H / 2.0, downscale=1,
        frontend=FrontendConfig(max_features=4096, num_octaves=4, upsample_input=True,
                                contrast_threshold=0.012, lowe_ratio=0.75),
        ransac=RansacConfig(essential_iters=2048, pnp_iters=1024),
        map=MapConfig(max_cameras=64, max_points=16384),
    )


def sift_pair(imgs, cfg):
    """K1's main-path inputs: real SIFT descriptors of frames 0 and 1."""
    from sfm_mvs_tpu_torch.ops import sift

    dev = DEVICE
    f0 = sift.detect_and_compute(torch.as_tensor(imgs[0], device=dev), cfg.frontend)
    f1 = sift.detect_and_compute(torch.as_tensor(imgs[1], device=dev), cfg.frontend)
    arr = [t.cpu().numpy() for t in (f0.desc, f1.desc, f0.valid, f1.valid)]
    return ("4096x4096-sift",) + tuple(arr) + (cfg.frontend.lowe_ratio,)


def stage_u8(imgs):
    """bench.py's input: the sequence on the card as uint8."""
    return torch.as_tensor(np.stack([(g * 255.0).astype(np.uint8) for g in imgs]),
                           device=DEVICE)


def gray_of(stack8, i):
    """Frame i of the staged sequence as float32 in [0, 1] (bench.py's detect input)."""
    return stack8[i].float() / 255.0


def bgr_of(stack8, i):
    """Frame i as a gray (H, W, 3) float32 image (bench.py's gray_bgr)."""
    return stack8[i][..., None].expand(-1, -1, 3).float()


def bench_frames(stack8, cfg, n_frames=None):
    """bench.py's per-frame loop (bench.py:123-129) on the first `n_frames`
    frames: bootstrap on frames 0 and 1, then per frame detect ->
    register_frame -> global BA (8 LM iterations, 15 CG). Returns the
    pipeline state and per-frame records (synchronized host wall, BA
    device span from CUDA events, BA stats, the frame's stats)."""
    from sfm_mvs_tpu_torch.models import ba
    from sfm_mvs_tpu_torch.models.incremental import init_from_bootstrap, register_frame
    from sfm_mvs_tpu_torch.ops import sift

    n = stack8.shape[0] if n_frames is None else n_frames
    K = torch.as_tensor(cfg.intrinsic_matrix(), device=DEVICE)

    def detect(i):
        return sift.detect_and_compute(gray_of(stack8, i), cfg.frontend)

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    pstate, st = init_from_bootstrap(gen, detect(0), detect(1), bgr_of(stack8, 1), K, cfg)
    records = [{"frame": 1, "reproj_error": float(st.reproj_error), "accepted": True}]
    for i in range(2, n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pstate, st = register_frame(gen, pstate, detect(i), bgr_of(stack8, i), cfg)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        mstate, bst = ba.bundle_adjust_map(pstate.map, max_iterations=8, cg_iters=15)
        e1.record()
        pstate = pstate._replace(map=mstate)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        records.append({
            "frame": i, "wall_s": wall, "ba_ms": e0.elapsed_time(e1),
            "reproj_error": float(st.reproj_error), "accepted": bool(st.accepted),
            "ba_initial_cost": float(bst.initial_cost), "ba_final_cost": float(bst.final_cost),
            "ba_iterations": int(bst.iterations), "ba_accepted": int(bst.accepted),
        })
    return pstate, records


def sweep_config(cfg):
    """bench.py's sweep (bench.py:224-234) at full size."""
    import dataclasses

    from sfm_mvs_tpu_torch.utils.config import SweepConfig

    return dataclasses.replace(cfg, sweep=SweepConfig(
        enabled=True, grow_points=65536, reproj_px=1.5, max_features=4096,
        contrast_threshold=0.0025, pair_strides=(1, 2)))


def bench_sweep(stack8, state, cfg):
    """bench.py's finalize (bench.py:235-242): re-detect every frame at the
    sweep's budget, then grow, sweep, cull and BA. Returns (state, info)."""
    from sfm_mvs_tpu_torch.models import densify

    n = int(state.num_cams)
    cfg_sweep = sweep_config(cfg)
    feats = densify.redetect_for_sweep([gray_of(stack8, i) for i in range(n)], cfg_sweep)
    bgr = [bgr_of(stack8, i) for i in range(n)]
    return densify.finalize_with_sweep(state, feats, bgr, cfg_sweep)


def _pose_quality(state, Rt_gt):
    from sfm_mvs_tpu_torch.utils import evaluate

    cam_valid = state.cam_valid.cpu().numpy()
    poses = state.poses.cpu().numpy()[cam_valid]
    n = len(poses)
    ate = evaluate.ate_rmse(poses, Rt_gt[:n]) if n >= 3 else float("inf")
    rot = float(evaluate.rotation_errors_deg(poses, Rt_gt[:n]).max())
    return n, ate, rot


def phase_bench(imgs, Rt_gt, cfg, ate_ba_off):
    """bench.py's path on the card: per-frame BA, then the sweep. Returns
    K1's launches and the map before the sweep."""
    from sfm_mvs_tpu_torch.models import map_store
    from sfm_mvs_tpu_torch.ops import matching_cuda

    stack8 = stage_u8(imgs)
    torch.cuda.reset_peak_memory_stats()
    matching_cuda.reset_launches()
    t0 = time.perf_counter()
    pstate, records = bench_frames(stack8, cfg)
    loop_s = time.perf_counter() - t0
    state = pstate.map
    n_cams, ate, rot = _pose_quality(state, Rt_gt)
    pts_before = int(state.point_valid.sum())
    obs_before = int(map_store.num_observations(state))
    last_rms = float(np.sqrt(records[-1]["ba_final_cost"]))
    ba_rms = [float(np.sqrt(r["ba_final_cost"])) for r in records[1:]]
    errs = [r["reproj_error"] for r in records]
    warm = records[3:]  # frames 4.. (the first BA'd frames pay allocator warm-up)
    wall = statistics.mean(r["wall_s"] for r in warm)
    ba_ms = statistics.median(r["ba_ms"] for r in warm)

    before_sweep = state
    t0 = time.perf_counter()
    state, info = bench_sweep(stack8, state, cfg)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = matching_cuda.launches
    pts = state.points[state.point_valid].cpu().numpy()
    obs_after = int(map_store.num_observations(state))
    rms_sweep = float(np.sqrt(info["final_cost"]))
    _, ate_sweep, rot_sweep = _pose_quality(state, Rt_gt)
    n_pairs = sum(max(0, n_cams - s) for s in sweep_config(cfg).sweep.pair_strides)
    expected = 1 + (len(imgs) - 2) + n_pairs
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    log(f"[bench] cameras {n_cams}/{len(imgs)} (v5e: 57/57)  ATE {ate:.6f} (v5e: 0.00225; "
        f"BA off, phase 4: {ate_ba_off:.6f})  max_rot_err_deg {rot:.4f}")
    log(f"[bench] last BA rms {last_rms:.4f} px (v5e: 0.4723)  max per-frame BA rms "
        f"{max(ba_rms):.4f} px  reproj_px mean {statistics.mean(errs):.4f} max {max(errs):.4f}")
    log(f"[bench] before sweep: points {pts_before} observations {obs_before} (v5e: 1526, 17495)")
    log(f"[bench] after sweep: points {len(pts)} observations {obs_after} (v5e: 30271, 74981); "
        f"swept {info['swept_points']}")
    log(f"[bench] sweep rms {rms_sweep:.4f} px (v5e: 0.2628)  ATE {ate_sweep:.6f} (v5e: 0.00198)"
        f"  max_rot_err_deg {rot_sweep:.4f}")
    log(f"[bench] wall/frame incl. BA {wall * 1e3:.1f} ms (warm mean of {len(warm)}, "
        f"synchronized host clock), {1.0 / wall:.3f} frames/s; loop total {loop_s:.1f} s")
    log(f"[bench] BA {ba_ms:.2f} ms/frame (CUDA events, median of {len(warm)}); "
        f"sweep {sweep_s:.2f} s; peak device memory {peak_gb:.2f} GiB")
    log(f"[bench] K1 launches {launches} (expected {expected})")
    with open("chiprun_out/chip_smoke_bench.json", "w") as fh:
        json.dump({"frames": records, "sweep": info, "sweep_s": sweep_s}, fh)
    if n_cams != len(imgs):
        raise AssertionError(f"bench path registered {n_cams}/{len(imgs)} cameras")
    if not ate < min(0.05, ate_ba_off):
        raise AssertionError(f"bench path ATE {ate} not below min(0.05, BA-off {ate_ba_off})")
    if not max(errs) < 1.0:
        raise AssertionError(f"a frame's reprojection error {max(errs)} >= 1 px")
    if not max(ba_rms) < 1.0:
        raise AssertionError(f"a frame's BA rms {max(ba_rms)} >= 1 px")
    if not rms_sweep < 1.0:
        raise AssertionError(f"sweep rms {rms_sweep} >= 1 px")
    if not np.isfinite(pts).all():
        raise AssertionError("non-finite map points after the sweep")
    if len(pts) < 15000:
        raise AssertionError(f"{len(pts)} points after the sweep, expected >= 15000")
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times, expected {expected}")
    return launches, before_sweep


def phase_driver(imgs, Rt_gt, cfg, ate_ba_off):
    """The driver's own BA and finalize on the card:
    ``IncrementalSfM(cfg, device="cuda")`` with a global BA after every
    frame (``BaConfig(enabled=True, max_iterations=8)``), then
    ``finalize()``: compaction, shrink, track remap, ``finalize_map`` and
    the sweep at bench.py's settings."""
    import dataclasses

    from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM
    from sfm_mvs_tpu_torch.ops import matching_cuda
    from sfm_mvs_tpu_torch.utils.config import BaConfig

    cfg_d = dataclasses.replace(sweep_config(cfg), ba=BaConfig(enabled=True, max_iterations=8))
    sfm = IncrementalSfM(cfg_d, device=DEVICE)
    matching_cuda.reset_launches()
    t0 = time.perf_counter()
    run_state = sfm.run(imgs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    n_cams, ate, rot = _pose_quality(run_state, Rt_gt)
    pts_run = int(run_state.point_valid.sum())
    t0 = time.perf_counter()
    state = sfm.finalize()
    torch.cuda.synchronize()
    fin_s = time.perf_counter() - t0
    launches = matching_cuda.launches

    info = sfm.finalize_info
    errs = [s["reproj_error"] for s in sfm.stats]
    walls = [s["wall_s"] for s in sfm.stats[3:]]
    pts = state.points[state.point_valid].cpu().numpy()
    _, ate_fin, rot_fin = _pose_quality(state, Rt_gt)
    n_pairs = sum(max(0, n_cams - s) for s in cfg_d.sweep.pair_strides)
    expected = (len(imgs) - 1) + n_pairs
    log(f"[driver] run with BA: cameras {n_cams}/{len(imgs)} ATE {ate:.6f} "
        f"max_rot_err_deg {rot:.4f} reproj_px max {max(errs):.4f} points {pts_run}")
    log(f"[driver] finalize: capacity {state.points.shape[0]} points {len(pts)} "
        f"final cost {info['final_cost']:.4f} px^2 (rms {np.sqrt(info['final_cost']):.4f} px) "
        f"ATE {ate_fin:.6f} max_rot_err_deg {rot_fin:.4f}")
    log(f"[driver] wall/frame incl. BA {statistics.mean(walls) * 1e3:.1f} ms (warm mean of "
        f"{len(walls)}, synchronized host clock); run {run_s:.1f} s, finalize {fin_s:.2f} s")
    log(f"[driver] K1 launches {launches} (expected {expected})")
    if n_cams != len(imgs):
        raise AssertionError(f"driver with BA registered {n_cams}/{len(imgs)} cameras")
    if not ate < min(0.05, ate_ba_off):
        raise AssertionError(f"driver with BA: ATE {ate} not below min(0.05, {ate_ba_off})")
    if not max(errs) < 1.0:
        raise AssertionError(f"driver with BA: a frame's reprojection error {max(errs)} >= 1 px")
    if not info["final_cost"] < 1.0:
        raise AssertionError(f"finalize final cost {info['final_cost']} >= 1 px^2")
    if not ate_fin < 0.05:
        raise AssertionError(f"ATE after finalize {ate_fin} >= 0.05")
    if not np.isfinite(pts).all():
        raise AssertionError("non-finite map points after finalize")
    if len(pts) < 15000:
        raise AssertionError(f"{len(pts)} points after finalize, expected >= 15000")
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times, expected {expected}")
    return launches


def phase_main(imgs, Rt_gt, cfg):
    from sfm_mvs_tpu_torch.models import map_store
    from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM
    from sfm_mvs_tpu_torch.ops import matching_cuda, sift

    sfm = IncrementalSfM(cfg, device=DEVICE)
    matching_cuda.reset_launches()
    t0 = time.perf_counter()
    state = sfm.run(imgs)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = matching_cuda.launches

    n_cams, ate, rot = _pose_quality(state, Rt_gt)
    errs = [s["reproj_error"] for s in sfm.stats]
    walls = [s["wall_s"] for s in sfm.stats[2:]]  # warm: after the first two frames
    wall = statistics.mean(walls)
    pts = state.points.cpu().numpy()[state.point_valid.cpu().numpy()]
    n_obs = int(map_store.num_observations(state))

    # Detection alone, warm, on the same frames (host clock, synchronized).
    det = []
    for img in imgs[2:12]:
        x = torch.as_tensor(img, device=DEVICE)
        torch.cuda.synchronize()
        t = time.perf_counter()
        sift.detect_and_compute(x, cfg.frontend)
        torch.cuda.synchronize()
        det.append(time.perf_counter() - t)

    log(f"[main] cameras {n_cams}/{len(imgs)} points {len(pts)} observations {n_obs}")
    log(f"[main] ATE {ate:.6f} max_rot_err_deg {rot:.4f} reproj_px mean "
        f"{statistics.mean(errs):.4f} max {max(errs):.4f}")
    log(f"[main] wall/frame {wall * 1e3:.1f} ms (warm mean of {len(walls)}), "
        f"{1.0 / wall:.3f} frames/s, total {total_s:.1f} s incl. first frames; "
        f"detect alone {statistics.median(det) * 1e3:.1f} ms/frame (median of {len(det)})")
    log(f"[main] K1 launches {launches} (expected {len(imgs) - 1})")
    with open("chiprun_out/chip_smoke_stats.json", "w") as fh:
        json.dump(sfm.stats, fh)
    if n_cams != len(imgs):
        raise AssertionError(f"registered {n_cams}/{len(imgs)} cameras")
    if not ate < 0.05:
        raise AssertionError(f"ATE {ate} >= 0.05")
    if not max(errs) < 1.0:
        raise AssertionError(f"a frame's reprojection error {max(errs)} >= 1 px")
    if launches != len(imgs) - 1:
        raise AssertionError(f"K1 launched {launches} times, expected {len(imgs) - 1}")
    if not np.isfinite(pts).all():
        raise AssertionError("non-finite map points")
    return launches, ate


def _device_busy_ms(prof):
    """(ms, count) of the device's activity in a torch.profiler trace: the
    union of its kernels' and copies' intervals (an operator's own device
    time repeats its kernels', so summing key_averages counts it twice)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3, len(spans)


def _profile_window(fn):
    """Run fn() under torch.profiler: (wall ms, device busy ms, device
    ops, profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy, n_ops = _device_busy_ms(prof)
    return wall, busy, n_ops, prof


class StageClock:
    """Synchronized host-clock times of named functions while active.

    Each (owner, attribute, key) in `targets` is wrapped so that every call
    synchronizes the device before and after and appends its seconds to
    ``calls[key]``; the originals come back on exit. Several attributes may
    share one key."""

    def __init__(self, targets):
        self.targets = targets
        self.calls: dict[str, list[float]] = {}
        self._saved = []

    def total(self, key) -> float:
        return sum(self.calls.get(key, []))

    def _wrap(self, fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls.setdefault(key, []).append(time.perf_counter() - t)
            return out

        return wrapper

    def __enter__(self):
        for owner, name, key in self.targets:
            fn = owner.__dict__[name]
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(fn, key))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Write an (H, W) uint8 image as an 8-bit grayscale PNG (numpy + zlib:
    one IHDR, one IDAT of unfiltered rows, IEND)."""
    h, w = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.hstack([np.zeros((h, 1), np.uint8), img.astype(np.uint8)])  # filter 0
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


FRAME_DIR = "chiprun_out/cli_frames"


def write_frames(stack8) -> None:
    """The staged uint8 frames as PNGs: the CLI decodes exactly bench.py's input."""
    shutil.rmtree(FRAME_DIR, ignore_errors=True)
    os.makedirs(FRAME_DIR)
    for i, img in enumerate(stack8.cpu().numpy()):
        write_png_gray(f"{FRAME_DIR}/frame_{i:03d}.png", img)


def cli_args(out: str, *flags: str) -> list[str]:
    """The CLI on the phase-4 scene and frontend settings, on the card."""
    W, H = SCENE["image_size"]
    f = SCENE["focal"]
    return ["--image-dir", FRAME_DIR, "--out", out, "--fx", str(f), "--fy", str(f),
            "--cx", str(W / 2.0), "--cy", str(H / 2.0), "--downscale", "1",
            "--max-features", "4096", "--lowe-ratio", "0.75", "--contrast-threshold", "0.012",
            "--max-cameras", "64", "--max-points", "16384", "--device", "cuda", *flags]


def _pose_csv_quality(path, Rt_gt):
    from sfm_mvs_tpu_torch.utils import evaluate, io

    n_vals = len(np.loadtxt(path))
    K, P = io.load_pose_csv(path)
    poses = io.poses_from_projections(K, P).astype(np.float32)
    ate = evaluate.ate_rmse(poses, Rt_gt[:len(poses)]) if len(poses) >= 3 else float("inf")
    return n_vals, len(poses), ate


def phase_cli(Rt_gt):
    """The port's CLI in this process, so K1's counter covers its run."""
    from sfm_mvs_tpu_torch import cli, native
    from sfm_mvs_tpu_torch.models import incremental, mvs
    from sfm_mvs_tpu_torch.ops import matching_cuda
    from sfm_mvs_tpu_torch.utils import io
    from sfm_mvs_tpu_torch.utils.config import SfmConfig, SweepConfig

    out = "chiprun_out/cli"
    shutil.rmtree(out, ignore_errors=True)
    args = cli_args(out, "--bootstrap", "auto", "--ba", "--ba-iterations", "8", "--finalize",
                    "--sweep", "--sweep-contrast", "0.0025", "--densify", "--no-gif")
    Sfm = incremental.IncrementalSfM
    matching_cuda.reset_launches()
    t0 = time.perf_counter()
    with StageClock([
        (native.ImageLoader, "get", "image load"), (Sfm, "run", "run"),
        (Sfm, "finalize", "finalize"), (mvs, "_depth_ranges", "MVS pass 1"),
        (mvs, "_plane_sweep_batch", "MVS pass 1"), (mvs, "_fuse_batch", "MVS pass 2"),
        (io, "to_ply", "PLY writes"),
    ]) as clock:
        rc = cli.main(args)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = matching_cuda.launches

    n = len(os.listdir(FRAME_DIR))
    n_vals, n_poses, ate = _pose_csv_quality(f"{out}/pose.csv", Rt_gt)
    sparse, _ = io.read_ply(f"{out}/sparse.ply")
    dense, _ = io.read_ply(f"{out}/dense.ply")
    os.remove(f"{out}/dense.ply")  # ~150 MB of ASCII; the copy back holds 64 MiB
    with open(f"{out}/metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    events = sorted({r["event"] for r in records})
    pair = next(r["pair"] for r in records if r["event"] == "bootstrap_auto")
    map_points = next(r["points"] for r in records if r["event"] == "finalize")
    window = SfmConfig().view_graph_window
    graph_pairs = sum(min(window, n - 1 - i) for i in range(n))
    swept = sum(n - s for s in SweepConfig().pair_strides)
    expected = graph_pairs + 1 + (n - 2) + swept
    log(f"[cli] rc {rc}; bootstrap pair {tuple(pair)}; pose.csv {n_vals} values "
        f"({n_poses} poses) ATE {ate:.6f}; map points after finalize {map_points}, "
        f"sparse.ply {len(sparse)} vertices; dense.ply {len(dense)} vertices; metrics "
        f"events {events}")
    log(f"[cli] K1 launches {launches} (expected {expected} = {graph_pairs} view-graph "
        f"pairs (window {window}) + 1 bootstrap + {n - 2} registrations + {swept} swept pairs)")
    log("[cli] stage wall (synchronized host clock): "
        + ", ".join(f"{k} {clock.total(k):.2f} s" for k in
                    ("image load", "run", "finalize", "MVS pass 1", "MVS pass 2", "PLY writes"))
        + f"; cli.main total {total_s:.2f} s")
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    if n_vals != 9 + n * 12 or not ate < 0.05:
        raise AssertionError(f"pose.csv: {n_vals} values (expected {9 + n * 12}), ATE {ate}")
    # to_ply keeps the points within mean centroid distance + 1.5 map units
    # (the reference's cleaning); at this map's scale (its unit is the
    # ~0.14-unit bootstrap baseline) that is about the nearer 60%.
    if map_points < 15000 or len(sparse) < 0.5 * map_points:
        raise AssertionError(f"{map_points} map points after finalize (>= 15000 expected), "
                             f"{len(sparse)} of them in sparse.ply")
    if len(dense) < 1_000_000 or not np.isfinite(dense).all():
        raise AssertionError(f"dense.ply: {len(dense)} vertices (>= 1e6 expected) or non-finite")
    missing = {"frame", "ba", "bootstrap_auto", "finalize"} - set(events)
    if missing:
        raise AssertionError(f"metrics.jsonl lacks events {sorted(missing)}")
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times, expected {expected}")
    return launches


def phase_resume():
    """Checkpoint every 20 frames, then resume from the last one into the
    same output: the resumed run must write the same pose.csv."""
    from sfm_mvs_tpu_torch import cli
    from sfm_mvs_tpu_torch.ops import matching_cuda
    from sfm_mvs_tpu_torch.utils import checkpoint

    out = "chiprun_out/resume"
    shutil.rmtree(out, ignore_errors=True)
    args = cli_args(out, "--bootstrap", "seq", "--checkpoint-every", "20", "--no-gif")
    n = len(os.listdir(FRAME_DIR))
    matching_cuda.reset_launches()
    t0 = time.perf_counter()
    rc_a = cli.main(args)
    run_a_s = time.perf_counter() - t0
    with open(f"{out}/pose.csv", "rb") as fh:
        pose_a = fh.read()
    latest = checkpoint.latest_checkpoint(f"{out}/checkpoints")
    t0 = time.perf_counter()
    rc_b = cli.main(args + ["--resume"])
    run_b_s = time.perf_counter() - t0
    with open(f"{out}/pose.csv", "rb") as fh:
        pose_b = fh.read()
    launches = matching_cuda.launches
    expected = (n - 1) + (n - 1 - 40)
    log(f"[resume] run A rc {rc_a} in {run_a_s:.1f} s; run B (--resume from {latest}) "
        f"rc {rc_b} in {run_b_s:.1f} s; pose.csv {len(pose_a)} bytes, equal: "
        f"{pose_a == pose_b}; K1 launches {launches} (expected {expected})")
    if rc_a != 0 or rc_b != 0:
        raise AssertionError(f"cli.main returned {rc_a}, {rc_b}")
    if latest is None or not latest.endswith("frame_00040.npz"):
        raise AssertionError(f"latest checkpoint {latest}, expected frame_00040.npz")
    if pose_a != pose_b:
        raise AssertionError("the resumed run's pose.csv differs from the uninterrupted run's")
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times, expected {expected}")
    shutil.rmtree(FRAME_DIR)
    return launches


class Capture:
    """Records the return values of a module function while active."""

    def __init__(self, owner, name):
        self.owner, self.name, self.values = owner, name, []

    def __enter__(self):
        fn = self.fn = getattr(self.owner, self.name)

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.values.append(out)
            return out

        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def phase_loop_cli(Rt_gt):
    """Phase 10: the incremental CLI with the flags phases 4-9 leave out: the
    five-point solver, bilinear SIFT sampling, BA, and loop closure (the
    full 1596-pair view graph, the 4 strongest non-adjacent pairs, injection
    both ways, robust BA, duplicate merging) in finalize."""
    from sfm_mvs_tpu_torch import cli, native
    from sfm_mvs_tpu_torch.models import exhaustive, incremental
    from sfm_mvs_tpu_torch.ops import matching_cuda

    out = "chiprun_out/loop"
    shutil.rmtree(out, ignore_errors=True)
    args = cli_args(out, "--bootstrap", "seq", "--essential-solver", "5pt", "--grad-sampling",
                    "bilinear", "--ba", "--ba-iterations", "8", "--loop-close", "4",
                    "--finalize", "--no-gif")
    Sfm = incremental.IncrementalSfM
    matching_cuda.reset_launches()
    t0 = time.perf_counter()
    with StageClock([(native.ImageLoader, "get", "image load"), (Sfm, "run", "run"),
                     (Sfm, "finalize", "finalize"),
                     (exhaustive, "build_view_graph", "view graph"),
                     (exhaustive, "inject_reobservations", "injection")]) as clock, \
            Capture(exhaustive, "strongest_loop_pairs") as pairs:
        rc = cli.main(args)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = matching_cuda.launches

    n = len(os.listdir(FRAME_DIR))
    n_vals, n_poses, ate = _pose_csv_quality(f"{out}/pose.csv", Rt_gt)
    with open(f"{out}/metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    fin = next(r for r in records if r["event"] == "finalize")
    errs = [r["reproj_error"] for r in records if r["event"] == "frame"]
    loop_pairs = pairs.values[0] if pairs.values else []
    graph_pairs = n * (n - 1) // 2
    expected = 1 + (n - 2) + graph_pairs + 2 * len(loop_pairs)
    log(f"[loop] rc {rc}; pose.csv {n_poses} poses ATE {ate:.6f}; reproj_px max "
        f"{max(errs):.4f}; loop pairs {loop_pairs}; loop-closure observations "
        f"{fin.get('loop_closure_obs')}; merged points {fin.get('merged_points')}; map points "
        f"{fin['points']}; robust cost {fin.get('robust_cost', float('nan')):.4f} px^2; final "
        f"cost {fin['round1_cost']:.4f} px^2")
    log(f"[loop] K1 launches {launches} (expected {expected} = 1 bootstrap + {n - 2} "
        f"registrations + {graph_pairs} view-graph pairs + 2 x {len(loop_pairs)} loop pairs)")
    log("[loop] stage wall (synchronized host clock): "
        + ", ".join(f"{k} {clock.total(k):.2f} s" for k in
                    ("image load", "run", "finalize", "view graph", "injection"))
        + f"; cli.main total {total_s:.2f} s")
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    if n_vals != 9 + n * 12 or not ate < 0.05:
        raise AssertionError(f"pose.csv: {n_vals} values (expected {9 + n * 12}), ATE {ate}")
    if not fin.get("loop_closure_obs", 0) > 0 or "merged_points" not in fin \
            or "robust_cost" not in fin:
        raise AssertionError(f"finalize event lacks loop closure: {sorted(fin)}")
    if not fin["round1_cost"] < 1.0:
        raise AssertionError(f"finalize cost {fin['round1_cost']} >= 1 px^2")
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times, expected {expected}")
    return launches


DIST = (-0.18, 0.03)


def phase_intrinsics(cfg):
    """Phase 11: the staircase rendered with radial distortion (k1, k2) =
    (-0.18, 0.03), reconstructed by a driver unaware of it (BA off), then
    the shared-intrinsics BA (the full-size twin of
    tests/test_distortion.py's k1 recovery) and the per-camera variant."""
    from sfm_mvs_tpu_torch.models import ba
    from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM
    from sfm_mvs_tpu_torch.ops import matching_cuda
    from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence

    t0 = time.time()
    imgs, Rt_gt, _ = render_staircase_sequence(**SCENE, dist=DIST)
    render_s = time.time() - t0
    # BA off, as in the test this mirrors: a per-frame pinhole BA absorbs
    # most of the distortion into the structure first (PERF.md, section 4).
    sfm = IncrementalSfM(cfg, device=DEVICE)
    matching_cuda.reset_launches()
    t0 = time.perf_counter()
    state = sfm.run(imgs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = matching_cuda.launches
    n_cams, ate0, _ = _pose_quality(state, Rt_gt)
    t0 = time.perf_counter()
    st_shared, stats, intr = ba.bundle_adjust_map_intrinsics(state, max_iterations=40, cg_iters=30)
    torch.cuda.synchronize()
    shared_s = time.perf_counter() - t0
    _, ate1, _ = _pose_quality(st_shared, Rt_gt)
    s, k1, k2 = (float(v) for v in intr.cpu())
    t0 = time.perf_counter()
    _, pstats, pc = ba.bundle_adjust_map_percam_intrinsics(state)
    torch.cuda.synchronize()
    percam_s = time.perf_counter() - t0
    rows = pc[:n_cams].cpu().numpy()
    log(f"[intr] distorted render {render_s:.1f} s; run, BA off (k1 = k2 = 0 assumed): cameras "
        f"{n_cams}/{len(imgs)} ATE {ate0:.6f} in {run_s:.1f} s; K1 launches {launches} "
        f"(expected {len(imgs) - 1})")
    log(f"[intr] shared [s, k1, k2] = [{s:.5f}, {k1:.5f}, {k2:.5f}] (true k1, k2 = {DIST}); cost "
        f"{float(stats.initial_cost):.4f} -> {float(stats.final_cost):.4f} px^2 in "
        f"{int(stats.iterations)} iterations; ATE {ate0:.6f} -> {ate1:.6f}; {shared_s:.2f} s")
    log(f"[intr] per camera: cost {float(pstats.initial_cost):.4f} -> "
        f"{float(pstats.final_cost):.4f} px^2; row 0 {rows[0].tolist()}; k1 median "
        f"{float(np.median(rows[1:, 1])):.5f}; {percam_s:.2f} s")
    if n_cams != len(imgs):
        raise AssertionError(f"distorted run registered {n_cams}/{len(imgs)} cameras")
    if not (k1 < 0 and abs(k1 - DIST[0]) < 0.5 * abs(DIST[0])):
        raise AssertionError(f"recovered k1 {k1}, expected within 50% of {DIST[0]}")
    if not float(stats.final_cost) < 0.5 * float(stats.initial_cost):
        raise AssertionError("shared-intrinsics BA did not halve the cost")
    if not ate1 < ate0:
        raise AssertionError(f"ATE after intrinsics BA {ate1} not below {ate0}")
    if not float(pstats.final_cost) <= float(pstats.initial_cost):
        raise AssertionError("per-camera intrinsics BA raised the cost")
    if not np.isfinite(rows).all() or rows[0].tolist() != [1.0, 0.0, 0.0]:
        raise AssertionError(f"per-camera intrinsics: non-finite rows or row 0 {rows[0]}")
    if launches != len(imgs) - 1:
        raise AssertionError(f"K1 launched {launches} times, expected {len(imgs) - 1}")
    return launches


PLANE = dict(num_cameras=11, image_size=(968, 648), focal=1200.0, radius=6.0, arc_degrees=30.0)
PLANE_DIR = "chiprun_out/plane_frames"


def phase_global(cfg):
    """Phase 12: --pipeline global on an 11-view textured plane (test.py's
    fountain-P11 has 11 views): ``GlobalSfM.run`` with global BA, its
    final sweep, then the CLI with --pipeline global --finalize."""
    from sfm_mvs_tpu_torch import cli
    from sfm_mvs_tpu_torch.models import ba
    from sfm_mvs_tpu_torch.models.tracks import GlobalSfM
    from sfm_mvs_tpu_torch.ops import matching_cuda
    from sfm_mvs_tpu_torch.utils.synthetic import render_plane_sequence

    imgs, Rt_gt, _ = render_plane_sequence(**PLANE)
    F = len(imgs)
    matching_cuda.reset_launches()
    t0 = time.perf_counter()
    g = GlobalSfM(cfg, device=DEVICE)
    state = g.run(imgs, run_ba=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    n_cams = int(state.cam_valid.sum())
    pts_run = int(state.num_points)
    cost = float(ba._cost(ba.problem_from_map(state)))
    t0 = time.perf_counter()
    swept = g.final_sweep(imgs)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    pts_swept = int(swept.num_points)
    _, ate, _ = _pose_quality(swept, Rt_gt)

    shutil.rmtree(PLANE_DIR, ignore_errors=True)
    os.makedirs(PLANE_DIR)
    for i, im in enumerate(imgs):
        write_png_gray(f"{PLANE_DIR}/frame_{i:03d}.png", (np.clip(im, 0, 1) * 255).astype(np.uint8))
    out = "chiprun_out/global"
    shutil.rmtree(out, ignore_errors=True)
    W, H = PLANE["image_size"]
    f = PLANE["focal"]
    args = ["--image-dir", PLANE_DIR, "--out", out, "--fx", str(f), "--fy", str(f),
            "--cx", str(W / 2.0), "--cy", str(H / 2.0), "--downscale", "1",
            "--max-features", "4096", "--lowe-ratio", "0.75", "--contrast-threshold", "0.012",
            "--max-cameras", "64", "--max-points", "16384", "--device", "cuda",
            "--pipeline", "global", "--finalize", "--no-gif"]
    t0 = time.perf_counter()
    rc = cli.main(args)
    cli_s = time.perf_counter() - t0
    launches = matching_cuda.launches
    n_vals, n_poses, ate_cli = _pose_csv_quality(f"{out}/pose.csv", Rt_gt)
    shutil.rmtree(PLANE_DIR)
    expected = 2 * ((F - 1) + (F - 1))
    log(f"[global] run: cameras {n_cams}/{F} points {pts_run} global BA cost {cost:.4f} px^2 "
        f"(before BA {g.stats[-1]['cost_before']:.4f}) in {run_s:.1f} s; final sweep -> "
        f"{pts_swept} points in {sweep_s:.1f} s; ATE {ate:.6f} (planar: E poses ambiguous, "
        f"not gated)")
    log(f"[global] CLI --pipeline global --finalize: rc {rc}, pose.csv {n_poses} poses ATE "
        f"{ate_cli:.6f} in {cli_s:.1f} s; K1 launches {launches} (expected {expected} = 2 x "
        f"({F - 1} pairs + {F - 1} swept pairs))")
    if n_cams != F or not pts_run > 100 or not cost < 4.0:
        raise AssertionError(f"global run: {n_cams}/{F} cameras, {pts_run} points, cost {cost}")
    if not pts_swept > pts_run:
        raise AssertionError(f"final sweep did not grow the map ({pts_run} -> {pts_swept})")
    if rc != 0 or n_vals != 9 + 12 * F:
        raise AssertionError(f"global CLI rc {rc}, pose.csv {n_vals} values")
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times, expected {expected}")
    return launches


MVS_RECORD = dict(rel_rms=0.01421, median=0.00299, under_1pct=0.8919, coverage_gt=0.8008,
                  points=5353610)  # artifacts/MVS_r05.json (v5e; quality only)


def phase_mvs(stack8, state, Rt_gt, gt_depths):
    """benchmarks/mvs_full.py's recipe on phase 5's map before its sweep."""
    from sfm_mvs_tpu_torch.models import mvs, refine
    from sfm_mvs_tpu_torch.utils import evaluate

    state, _ = refine.finalize_map(state, max_iterations=20)
    n = int(state.cam_valid.sum())
    poses = state.poses.cpu().numpy()[:n]
    s_align, _, _ = evaluate.umeyama_alignment(evaluate.camera_centers(poses),
                                               evaluate.camera_centers(Rt_gt[:n]))
    grays = [gray_of(stack8, i) for i in range(n)]
    bgrs = [bgr_of(stack8, i) for i in range(n)]
    torch.cuda.reset_peak_memory_stats()
    with StageClock([(mvs, "_depth_ranges", "pass 1"), (mvs, "_plane_sweep_batch", "pass 1"),
                     (mvs, "_fuse_batch", "pass 2")]) as clock:
        pts, _, dms = mvs.densify_map(
            grays, state, num_depths=64, stride=2, images_bgr=bgrs, geo_rel_tol=0.02,
            edge_trim_radius=6, geo_min_consistent=2, free_space_rel=0.05, min_conf=0.5,
            return_depth_maps=True)
    rels, covs_gt = [], []
    for r, dm in dms.items():
        d_est = dm.depth.cpu().numpy() * s_align
        d_gt = gt_depths[r]
        gt_ok = d_gt > 0.1
        ok = dm.valid.cpu().numpy() & gt_ok
        covs_gt.append(ok.sum() / max(gt_ok.sum(), 1))
        rels.append(np.abs(d_est[ok] - d_gt[ok]) / d_gt[ok])
    rel = np.concatenate(rels)
    rms, med = float(np.sqrt(np.mean(rel ** 2))), float(np.median(rel))
    under, cov = float(np.mean(rel < 0.01)), float(np.mean(covs_gt))
    rec = MVS_RECORD
    log(f"[mvs] depth rel-RMS {rms:.5f} (v5e record: {rec['rel_rms']})  median {med:.5f} "
        f"(v5e record: {rec['median']})  under 1% {under:.4f} (v5e record: {rec['under_1pct']})")
    log(f"[mvs] coverage of GT-valid pixels {cov:.4f} (v5e record: {rec['coverage_gt']})  "
        f"dense points {len(pts)} (v5e record: {rec['points']})  scale {s_align:.5f}")
    log(f"[mvs] pass 1 {clock.total('pass 1'):.2f} s, pass 2 {clock.total('pass 2'):.2f} s "
        f"(synchronized host clock, {n} reference frames, batches of 4); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not med < 0.01 or not rms < 0.03:
        raise AssertionError(f"depth error median {med} / rel-RMS {rms} above 0.01 / 0.03")
    if not cov > 0.65:
        raise AssertionError(f"coverage of GT-valid pixels {cov} <= 0.65")
    if not np.isfinite(pts).all():
        raise AssertionError("non-finite dense points")
    return state


def profile_sweep(stack8, state):
    """torch.profiler over one ``mvs._plane_sweep_batch`` call of 4 reference
    frames (10..13, each with its 4 sweep neighbors), as densify_map makes it."""
    from sfm_mvs_tpu_torch.models import mvs

    refs = [10, 11, 12, 13]
    nbrs = [[r - 2, r - 1, r + 1, r + 2] for r in refs]
    lo, hi = mvs._depth_ranges(state)
    idx = torch.as_tensor(refs, device=DEVICE)
    nidx = torch.as_tensor(nbrs, device=DEVICE)
    imgs = stack8.float() / 255.0

    def sweep():
        return mvs._plane_sweep_batch(imgs[idx], imgs[nidx], state.poses[idx],
                                      state.poses[nidx], state.K, lo[idx], hi[idx])

    sweep()
    wall, busy, n_ops, prof = _profile_window(sweep)
    summary = (f"[profile] one _plane_sweep_batch of 4 refs at {tuple(imgs.shape[1:])}, "
               f"4 neighbors, 64 depths: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
               f"idle share {1 - busy / wall:.3f}, {n_ops} device ops")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25,
                                      max_name_column_width=70)
    with open("chiprun_out/profile.txt", "a") as fh:
        fh.write("\n".join([summary, table]) + "\n")
    log(summary)


def phase_profile(imgs, cfg, n_frames=10):
    """Where the time goes (``--profile`` only): the synchronized wall time
    of each stage of bench.py's path over its first ``n_frames`` frames and
    a sweep over them, then torch.profiler over two warm frames with BA and
    over one LM iteration at the same map size, for the device's busy share
    and its busiest operations. Full tables go to chiprun_out/profile.txt."""
    from sfm_mvs_tpu_torch.models import ba, densify, incremental, map_store, refine
    from sfm_mvs_tpu_torch.ops import matching, pnp, ransac, sift, triangulation

    stack8 = stage_u8(imgs[:n_frames])
    with StageClock([
        (sift, "detect_and_compute", "detect"),
        (matching, "match_with_config", "match"),
        (ransac, "ransac_pnp", "ransac_pnp"),
        (pnp, "refine_pose_gauss_newton", "pnp_polish (2 per frame)"),
        (triangulation, "triangulate_euclidean", "triangulate"),
        (map_store, "append_points", "append_points"),
        (map_store, "append_observations", "append_observations (4 per frame)"),
        (incremental, "register_frame", "register_frame"),
        (ba, "bundle_adjust_map", "ba.bundle_adjust_map (8 LM iterations)"),
        (ba, "_lm_solve", "ba._lm_solve (one LM iteration's solve)"),
        (densify, "sweep_pair", "densify.sweep_pair"),
        (refine, "cull_map", "refine.cull_map"),
    ]) as clock:
        pstate, records = bench_frames(stack8, cfg)
        bench_sweep(stack8, pstate.map, cfg)
    frame_ms = [r["wall_s"] * 1e3 for r in records[1:]]
    lines = [f"bench path, frames 2..{n_frames - 1} wall ms incl. BA: "
             + ", ".join(f"{t:.1f}" for t in frame_ms)]
    for key, secs in clock.calls.items():
        warm = secs[2:] if len(secs) > 4 else secs
        lines.append(f"{key:42s} n={len(secs):4d} median {statistics.median(warm) * 1e3:8.2f} ms")

    # Two warm frames with BA (features detected beforehand), then one LM
    # iteration (solve + candidate cost) on the map they leave.
    dev = DEVICE
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    feats = [sift.detect_and_compute(gray_of(stack8, i), cfg.frontend) for i in range(5)]
    bgr = [bgr_of(stack8, i) for i in range(5)]
    K = torch.as_tensor(cfg.intrinsic_matrix(), device=dev)
    box = {}
    box["ps"], _ = incremental.init_from_bootstrap(gen, feats[0], feats[1], bgr[1], K, cfg)

    def frame(i):
        ps, _ = incremental.register_frame(gen, box["ps"], feats[i], bgr[i], cfg)
        mstate, _ = ba.bundle_adjust_map(ps.map, max_iterations=8, cg_iters=15)
        box["ps"] = ps._replace(map=mstate)

    frame(2)
    wall, busy, n_ops, prof = _profile_window(lambda: (frame(3), frame(4)))
    summary = (f"[profile] 2 warm frames (register + BA): wall {wall:.1f} ms, device busy "
               f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}, {n_ops} device ops")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=30,
                                      max_name_column_width=70)

    prob = ba.problem_from_map(box["ps"].map)
    lam = torch.tensor(1e-3, device=dev)

    def lm_iteration():
        dc, dp, _ = ba._lm_solve(prob, lam, 15)
        ba._cost(prob._replace(cam_params=prob.cam_params + dc, points=prob.points + dp))

    lm_iteration()
    wall_i, busy_i, ops_i, prof_i = _profile_window(lm_iteration)
    P, C = prob.obs_mask.shape
    summary_i = (f"[profile] one LM iteration at P={P}, C={C} (15 CG steps): wall "
                 f"{wall_i:.2f} ms, device busy {busy_i:.2f} ms, idle share "
                 f"{1 - busy_i / wall_i:.3f}, {ops_i} device ops")
    table_i = prof_i.key_averages().table(sort_by="self_device_time_total", row_limit=25,
                                          max_name_column_width=70)
    with open("chiprun_out/profile.txt", "w") as fh:
        fh.write("\n".join(lines + [summary, table, summary_i, table_i]) + "\n")
    for ln in lines:
        log(f"[profile] {ln}")
    log(summary)
    log(summary_i)


def microbench() -> None:
    """The card's limits behind K1's design (csrc/microbench.cu), each a
    kernel timed with CUDA events after a warm-up launch."""
    import ctypes

    from sfm_mvs_tpu_torch.ops import matching_cuda

    src = matching_cuda._SRC.with_name("microbench.cu")
    out = matching_cuda._BUILD_DIR / "libmicrobench.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in matching_cuda._NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([matching_cuda._nvcc(), *flags, "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.mb_ffma.argtypes = [i, i, i, p, p]
    lib.mb_lds128.argtypes = [i, i, i, p]
    lib.mb_copy.argtypes = [i, i, i, p, p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]) * 1e6

    def timed(fn, *args):
        for _ in range(2):
            if fn(*args):
                raise RuntimeError(f"{fn.__name__} failed to launch")
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e-3

    fout = torch.zeros(1, device=DEVICE)
    iout = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    vals = torch.rand(256, device=DEVICE)
    for outer, name, fmas in ((0, "independent chains", 128), (1, "8x8 outer product", 256)):
        blocks, iters = 2 * sms, 20000
        secs = timed(lib.mb_ffma, outer, blocks, iters, fout.data_ptr(), vals.data_ptr())
        log(f"[micro] FFMA {name}: {2 * blocks * 256 * iters * fmas / secs / 1e12:.1f} TFLOP/s")
    for mode, name in enumerate(("32 distinct", "8 distinct per quarter-warp (knn2 train)",
                                 "1 per quarter-warp", "1 per half-warp (knn2 query)", "1 per warp")):
        blocks, iters = 4 * sms, 4096
        secs = timed(lib.mb_lds128, mode, blocks, iters, iout.data_ptr())
        per_sm = blocks * 16 * iters * 8 / sms
        log(f"[micro] LDS.128, {name}: {secs * clock_hz / per_sm:.2f} SM cycles per warp load")
    g = torch.rand(64 * 128 * 128, device=DEVICE)
    for wide, name in ((0, "4-byte cp.async, transposed"), (1, "16-byte cp.async")):
        blocks, iters = 2 * sms, 4000
        secs = timed(lib.mb_copy, wide, blocks, iters, g.data_ptr(), fout.data_ptr())
        log(f"[micro] {name}: {secs * clock_hz / (blocks * iters / sms):.1f} SM cycles per "
            f"2048-float chunk")
    log(f"[micro] at {clock_hz / 1e6:.0f} MHz (clocks.max.sm), {sms} SMs")


def main(argv) -> int:
    t_start = time.time()
    smi = phase_device()
    import sfm_mvs_tpu_torch  # noqa: F401  (sets full-fp32 matmul flags)
    from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence

    os.makedirs("chiprun_out", exist_ok=True)
    if "--microbench" in argv:
        microbench()
        return 0
    build_s, registers, spills = phase_build()
    t0 = time.time()
    imgs, Rt_gt, _, gt_depths = render_staircase_sequence(**SCENE, return_depth=True)
    log(f"[scene] rendered {len(imgs)} frames {SCENE['image_size']} in {time.time() - t0:.1f}s")
    cfg = main_config()
    k1 = phase_k1(sift_pair(imgs, cfg))
    launches, ate_ba_off = phase_main(imgs, Rt_gt, cfg)
    n, bench_map = phase_bench(imgs, Rt_gt, cfg, ate_ba_off)
    launches += n
    launches += phase_driver(imgs, Rt_gt, cfg, ate_ba_off)
    stack8 = stage_u8(imgs)
    write_frames(stack8)
    launches += phase_cli(Rt_gt)
    launches += phase_loop_cli(Rt_gt)
    launches += phase_resume()
    mvs_map = phase_mvs(stack8, bench_map, Rt_gt, gt_depths)
    launches += phase_intrinsics(cfg)
    launches += phase_global(cfg)
    if "--profile" in argv:
        phase_profile(imgs, cfg)
        profile_sweep(stack8, mvs_map)
    log(f"[total] {time.time() - t_start:.1f} s, kernel build included")
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "knn2", "route": "cuda", "source": "sfm_mvs_tpu_torch/csrc/knn2.cu",
        "replaces": "sfm_mvs_tpu/ops/matching_pallas.py:55", "launches": launches,
        **k1, "registers": registers, "spills": spills,
    }], "build_s": build_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
