"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the check

Phases, each printing one line (any failure exits non-zero):

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles the port's CUDA sources (csrc/*.cu) with nvcc; the
   registers and spill bytes of K1's tile kernel and of the MVS kernels
   from the ptxas reports (spills fail).
3. K1: the 2-NN matcher kernel against its plain PyTorch version on the
   card, on nine cases (five of PR 1; exact ties across tiles and across
   splits, where d1 == d2 bitwise at the lower column; train sets of 1 and
   100 columns), then the kernel, the plain version and ``torch.mm`` of the
   cross term (the library yardstick) timed at 4096 x 4096 x 128 in turns,
   launch-amortized (50 back-to-back calls between CUDA events, median of 5
   windows), beside the FP32-FMA bound; the device ops of one call counted
   under torch.profiler (at most 6). Then the batched launch: 8 SIFT pairs
   (frames (i, i+1)) in one ``knn_match_cuda_batch`` call, bitwise equal to
   8 single launches and within the same margins of the plain batched
   version, timed per pair beside a single launch, ``torch.bmm`` of the
   batched cross term and the bound for 8 pairs.
3b. MVS pass 1's kernels (``csrc/mvs_sweep.cu``) on two chunks of 4
   references with 4 neighbours each and ground-truth poses: portbench's
   fountain11 scene at 1536x1024 (references 4-7; every level whole 32-px
   tiles) and the staircase scene at 968x648 (references 10-13; every
   level ends in ragged tiles, as phase 9 and the CLI's --densify run).
   ``_plane_sweep_batch`` on the card must launch them 6 times (3
   zero-mean, 3 sweep levels; the tracer's ``mvs.sweep_kernel``). At each
   level, pinhole and again with ``dist``, the kernel's (invd, best_cost,
   mean_cost, den_best) and its cost of every hypothesis are held to the
   plain ``_sweep_select_plain`` in float64 on the same float32 inputs,
   beside the plain code in float32 (the path they replace): relative
   cost errors (below a cost of 1e-3, absolute to 1e-8) with a median
   within 1e-5 and no larger a share above 1e-5 than the float32 plain
   code's, over the whole image and again over the edge band (the ragged
   last tile column and row, and the border within the filter's radius;
   for mean_cost, which sums all D costs, the share is compared outside
   the pixels where both paths' cost of some hypothesis is 1e-4 off, a
   tap both round to another pixel, and its mean error over the whole
   image must be no larger than the plain code's besides);
   the chosen hypothesis, where float64's best two costs are
   clear (more than that apart), and invd there (half a hypothesis step),
   differing no more often than the float32 plain code's; the kernel's
   selection equal bit for bit to its own costs' (best, den, mean); the
   zero-mean images within 1e-6 of float64 and no further than the plain
   code's. Then each launch's time beside its taps at one load a lane a
   cycle, and pass 1 of the fountain chunk through the kernels and through
   the plain code (launch-amortized ms, launches, device ops).
3c. bundle adjustment as a CUDA graph: ``run_ba`` on a CUDA problem
   replays its LM loop as one captured graph per problem key. On synthetic
   problems at fountain11's map capacity (11 cameras, 16384 points; 8 LM
   iterations, 15 CG steps; also with the shared and the per-camera
   intrinsics) and gustav57's (64, 16384; 8 iterations, 20 CG steps, and
   finalize's robust BA: 30 iterations, Huber 3 px), the eager loop and
   the graph path must return the same outputs and stats bit for bit
   (else a relative final-cost difference of at most 1e-6). Four calls of
   one key: the first (problem a) and the second (problem b) run the eager
   loop, the third (b) captures and replays, the fourth (a) replays; they
   must count 1 ``ba.graph_captures`` and 2 ``ba.graph_replays``, the
   first and the fourth the same four BA step counters, and the fourth
   must leave the third's returned tensors as they were. Prints ms a call
   both ways (synchronized, median of 5), the first call's and the
   capturing call's (warm-up, capture and replay), and the host's kernel
   launches in one replayed call (torch.profiler).
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
   15,000 finite points at sub-pixel rms after the sweep, 167 K1
   launches (1 bootstrap + 55 frames + 56 + 55 swept pairs), and BA
   graph replays on every frame but the per-frame key's first two, with
   at most one capture (the tracer's ``ba.graph_replays``,
   ``ba.graph_captures``).
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
   bootstrap tries, the guard's retries counted, + registrations + swept
   pairs); prints each stage's wall.
8. resume: the CLI with ``--bootstrap seq --checkpoint-every 20``, then
   again with ``--resume`` from frame 40 into the same output; the two
   pose.csv files must be equal byte for byte.
9. MVS against ground truth (benchmarks/mvs_full.py's recipe): phase 5's
   map before its sweep, ``refine.finalize_map(max_iterations=20)``, then
   ``mvs.densify_map`` with the GT harness's settings; checks depth
   relative error (median < 0.01, RMS < 0.03), coverage of GT-valid pixels
   > 0.65 and finite points, beside the v5e quality record, and that every
   chunk went through the MVS kernels (``mvs.sweep_kernel`` 6 a chunk).
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
13. KLT: ``KltSfM(cfg, redetect_every=5, device="cuda")`` on phase 4's
    frames and config (tracking, PnP, triangulation, replenishment); gates
    are tests/test_klt_pipeline.py's bounds where the JAX package's record on
    the same frames meets them, else no worse than that record by more than
    20%; 1 K1 launch (the bootstrap).
14. split-phase stitching at benchmarks/large_scene.py's width: 250 frames
    at 480x360 over 145 degrees registered by ``IncrementalSfM`` with
    windowed BA, then ``covisibility_matrix``, ``retrieve_stitch_pairs``,
    chunks of 32 pairs through ``stitch_candidates_batch`` (one batched K1
    launch and one batched E-RANSAC per chunk) and ``apply_stitch_batch``
    both ways, then the finalize (compact, shrink, 2 robust BA rounds each
    followed by a re-apply of every candidate, ``finalize_map``); checks
    250/250, ATE < 0.05, injections > 0, a re-apply that injects nothing, a
    final cost below 1 px^2, 249 single K1 launches in registration and one
    batched launch of 32 pair rows per stitch chunk.
15. the distributed paths (``sfm_mvs_tpu_torch/parallel``) at full width:
    phase 5's map, phase 14's registration map and phase 9's finalized map
    are saved with ``utils/checkpoint.save_map`` and 2 gloo ranks sharing
    cuda:0 are spawned (torch.multiprocessing), then 1 NCCL rank. Each runs
    ``bundle_adjust_map_sharded`` (8 iterations, 15 CG) against the
    single-process ``bundle_adjust_map`` at tests/test_parallel.py's
    tolerances (costs rel 1e-5 / 1e-2, poses 1e-4, points 1e-3), replicas
    bitwise equal; the gloo ranks also run ``bundle_adjust_window_sharded``
    at large_scene.py's window (32 cameras, 16384 points, 6 iterations)
    against ``bundle_adjust_window``, ``detect_batch_sharded`` on the 57
    frames in chunks of 8 (xy 1e-4, valid equal to per-frame detection),
    ``match_pairs_sharded`` over the 56 adjacent pairs (each rank's 28 in
    one batched K1 launch; idx1 and valid equal to single launches), the
    sharded lookup (exact) and nearest-projected query (d2 rel 1e-5) on
    phase 5's map, and ``densify_map(mesh=)`` at phase 9's settings (point
    count within max(5, n/100) of phase 9's, rounded-point overlap > 0.98,
    the same cloud on both ranks, phase 9's depth gates, 6 MVS kernel
    launches a chunk on each rank). Prints wall and
    per-LM-iteration times and each rank's time for one all_reduce of 384
    floats (a CG step's), which are of ranks sharing one card.
16. the last line: {"ok": true, "device": {...}}.

The scenes of phases 11 and 14 are rendered on the host by one spawned
worker process, started after the build, while phases 3-10 drive the card.

    python3 chip_smoke.py --mvs  # phases 1, 2 and 3b only (~2 min)

    python3 chip_smoke.py --ba-graph  # phases 1 and 3c only (~2 min)
"""

from __future__ import annotations

import json
import os
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


def tracer_start() -> None:
    """Count kernel launches from here: the port's tracer on and empty."""
    from sfm_mvs_tpu_torch.utils import profiling

    profiling.reset()
    profiling.enable()


def k1_counts() -> tuple:
    """(single launches, batched launches, pairs of the batched launches)
    since :func:`tracer_start`, from the tracer's ``k1.*`` counters (the
    frame records of ``IncrementalSfM`` are read from the tracer, which
    keeps them too). Turns the tracer off."""
    from sfm_mvs_tpu_torch.utils import profiling

    totals = profiling.summary(profiling.export())["counters"]
    profiling.disable()
    profiling.reset()
    return tuple(int(totals.get(f"k1.{k}", 0)) for k in ("launches", "batch_launches",
                                                           "batch_pairs"))


def mvs_kernel_count() -> int:
    """MVS pass 1's kernel launches since :func:`tracer_start`, from the
    tracer's ``mvs.sweep_kernel``. Turns the tracer off."""
    from sfm_mvs_tpu_torch.utils import profiling

    n = int(profiling.summary(profiling.export())["counters"].get("mvs.sweep_kernel", 0))
    profiling.disable()
    profiling.reset()
    return n


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
    """Compile csrc/knn2.cu and csrc/mvs_sweep.cu; returns (seconds,
    registers, spill bytes) of K1's tile kernel and {kernel: (registers,
    spill bytes)} of the MVS kernels, from the ptxas reports. Spills fail."""
    from sfm_mvs_tpu_torch.ops import cuda_build, matching_cuda, mvs_cuda

    t0 = time.time()
    path = matching_cuda.build()
    secs = time.time() - t0
    report = [ln.strip() for ln in matching_cuda.LIB.log.splitlines()
              if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    log(f"[build] csrc/knn2.cu -> {path.name} in {secs:.1f}s; " + " | ".join(report))
    registers = spills = None
    for entry, (regs, spill) in cuda_build.ptxas_report(matching_cuda.LIB.log).items():
        if "knn2_tile_kernel" in entry:
            registers, spills = regs, spill
    if registers is None or spills is None:
        raise AssertionError("no ptxas report for knn2_tile_kernel")
    if spills:
        raise AssertionError(f"knn2_tile_kernel spills {spills} bytes")
    t0 = time.time()
    path = mvs_cuda.build()
    mvs_regs = {name: regs for entry, regs in cuda_build.ptxas_report(mvs_cuda.LIB.log).items()
                for name in ("sweep_kernel", "zero_mean_kernel") if name in entry}
    log(f"[build] csrc/mvs_sweep.cu -> {path.name} in {time.time() - t0:.1f}s; "
        f"(registers, spill bytes) {mvs_regs}")
    if len(mvs_regs) != 2 or any(r is None or sp is None for r, sp in mvs_regs.values()):
        raise AssertionError(f"no ptxas report for the MVS kernels:\n{mvs_cuda.LIB.log}")
    if any(sp for _, sp in mvs_regs.values()):
        raise AssertionError(f"an MVS kernel spills: {mvs_regs}")
    secs += time.time() - t0
    return secs, registers, spills, mvs_regs


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


def k1_bound_ms(n0, n1, d, batch=1):
    """(ms, bound_by): the least time of one call for `batch` pairs on an
    H100 SXM: the cross terms' 2 n0 n1 d FP32 operations per pair at 67
    TFLOP/s (CUDA cores; the tensor cores have no FP32 mode), or their
    bytes (descriptors and masks read once; idx0, idx1 and valid written
    once) at 3.35 TB/s."""
    ops_ms = batch * 2.0 * n0 * n1 * d / 67e12 * 1e3
    bytes_ms = batch * ((n0 + n1) * (4 * d + 1) + n0 * 9) / 3.35e12 * 1e3
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


def sift_pairs(imgs, cfg, n_pairs):
    """The batched case's inputs: real SIFT descriptors of frames 0..n_pairs
    as the stacked adjacent pairs (i, i + 1), each (B, 4096, ...)."""
    from sfm_mvs_tpu_torch.ops import sift

    fs = [sift.detect_and_compute(torch.as_tensor(imgs[i], device=DEVICE), cfg.frontend)
          for i in range(n_pairs + 1)]
    desc = torch.stack([f.desc for f in fs])
    valid = torch.stack([f.valid for f in fs])
    return desc[:-1].contiguous(), desc[1:].contiguous(), valid[:-1].contiguous(), \
        valid[1:].contiguous()


def phase_k1_batch(pairs, ratio):
    """K1's batched launch (B pairs in one launch) against B single launches
    (bitwise: d1, j1, d2, idx0, idx1, valid) and against the plain batched
    version (phase 3's margins), then timed per pair in turns beside one
    single launch and ``torch.bmm`` of the batched cross term."""
    from sfm_mvs_tpu_torch.ops import matching, matching_cuda

    d0, d1, v0, v1 = pairs
    B, n0, dd = d0.shape
    n1 = d1.shape[1]
    kd1, kj1, kd2 = matching_cuda.knn2_raw(d0, d1, v1)
    km = matching_cuda.knn_match_cuda_batch(d0, d1, v0, v1, ratio=ratio)
    n_diff = 0
    for b in range(B):
        sd1, sj1, sd2 = matching_cuda.knn2_raw(d0[b], d1[b], v1[b])
        sm = matching_cuda.knn_match_cuda(d0[b], d1[b], v0[b], v1[b], ratio=ratio)
        n_diff += sum(not torch.equal(x, y) for x, y in (
            (kd1[b], sd1), (kj1[b], sj1), (kd2[b], sd2), (km.idx0[b], sm.idx0),
            (km.idx1[b], sm.idx1), (km.valid[b], sm.valid)))
    pd1, pj1, pd2 = matching.top2(matching.distance_matrix(d0, d1, v1))
    pm = matching.knn_match(d0, d1, v0, v1, ratio=ratio)
    torch.cuda.synchronize()
    q = v0
    err = max(float((kd1 - pd1)[q].abs().max()), float((kd2 - pd2)[q].abs().max()))
    decided = (pd2 - pd1) > MARGIN
    clear = (pd1 - (ratio * ratio) * pd2).abs() > MARGIN
    n_idx = int((q & decided & (kj1 != pj1.to(torch.int32))).sum())
    n_val = int((clear & (km.valid != pm.valid)).sum())
    n_inside = int((q & (~decided | ~clear)).sum())
    log(f"[k1] batched {B} x {n0}x{n1}x{dd} (SIFT pairs (i, i+1), i < {B}): against {B} single "
        f"launches {n_diff} differing outputs of {6 * B} (bitwise); against the plain batched "
        f"version max|dd|={err:.3g}, idx_mismatch={n_idx} valid_mismatch={n_val} "
        f"inside_margin={n_inside} matches={int(pm.valid.sum())}/{B * n0}")
    if n_diff or not err <= DIST_ATOL or n_idx or n_val or bool((km.valid & ~q).any()):
        raise AssertionError("K1's batched launch disagrees with single launches or the plain "
                             "version")

    fns = {"plain": lambda: matching.knn_match(d0, d1, v0, v1, ratio=ratio),
           "batched": lambda: matching_cuda.knn_match_cuda_batch(d0, d1, v0, v1, ratio=ratio),
           "library": lambda: torch.bmm(d0, d1.transpose(1, 2)),
           "single": lambda: matching_cuda.knn_match_cuda(d0[0], d1[0], v0[0], v1[0],
                                                          ratio=ratio)}
    windows = {k: [] for k in fns}
    turns = []
    for key in ("plain", "batched", "library", "single", "batched", "plain"):
        w = _window_ms(fns[key], calls=20 if key != "single" else 50)
        windows[key] += w
        turns.append(f"{key} {statistics.median(w):.4f}")
    ms = {k: statistics.median(v) for k, v in windows.items()}
    bound, bound_by = k1_bound_ms(n0, n1, dd, batch=B)
    log(f"[k1] batched time (ms per call of {B} pairs, CUDA events, median of 5 windows per "
        f"turn; single: one pair): " + ", ".join(turns))
    log(f"[k1] per pair: batched {ms['batched'] / B:.4f} ms, single launch {ms['single']:.4f} ms, "
        f"torch.bmm cross term {ms['library'] / B:.4f} ms, plain {ms['plain'] / B:.4f} ms; "
        f"bound {bound / B:.4f} ms ({bound_by}), share {bound / ms['batched']:.3f}")
    return dict(max_abs_err=err, ms=ms["batched"], plain_ms=ms["plain"],
                library_ms=ms["library"], bound_ms=bound, bound_by=bound_by,
                bound_share=bound / ms["batched"], pairs_per_call=B,
                single_ms=ms["single"])


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
    from sfm_mvs_tpu_torch.utils import profiling

    stack8 = stage_u8(imgs)
    torch.cuda.reset_peak_memory_stats()
    tracer_start()
    t0 = time.perf_counter()
    pstate, records = bench_frames(stack8, cfg)
    loop_s = time.perf_counter() - t0
    counters = profiling.summary(profiling.export())["counters"]
    graph_calls = (int(counters.get("ba.graph_captures", 0)),
                   int(counters.get("ba.graph_replays", 0)))
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
    launches = k1_counts()[0]
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
    log(f"[bench] K1 launches {launches} (expected {expected}); BA graph captures, replays "
        f"{graph_calls} (expected at most 1, at least {len(imgs) - 4})")
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
    if graph_calls[0] > 1 or not len(imgs) - 4 <= graph_calls[1] <= len(imgs) - 2:
        raise AssertionError(f"per-frame BA: graph captures, replays {graph_calls}, expected at "
                             f"most 1 and a replay a frame but the key's first two")
    return launches, before_sweep


def phase_driver(imgs, Rt_gt, cfg, ate_ba_off):
    """The driver's own BA and finalize on the card:
    ``IncrementalSfM(cfg, device="cuda")`` with a global BA after every
    frame (``BaConfig(enabled=True, max_iterations=8)``), then
    ``finalize()``: compaction, shrink, track remap, ``finalize_map`` and
    the sweep at bench.py's settings."""
    import dataclasses

    from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM
    from sfm_mvs_tpu_torch.utils.config import BaConfig

    cfg_d = dataclasses.replace(sweep_config(cfg), ba=BaConfig(enabled=True, max_iterations=8))
    sfm = IncrementalSfM(cfg_d, device=DEVICE)
    tracer_start()
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
    launches = k1_counts()[0]

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


def ba_graph_problem(C, P, n_cams, n_points, seed, width=6):
    """A BAProblem at map capacity (C, P) on the card: `n_cams` cameras
    8 units from the origin on a 40 deg arc around it, `n_points` points in
    a 4-unit box there, each seen by 2-8 consecutive cameras with 0.3 px
    noise; points perturbed by 0.05, cameras 1.. by 0.01 rad and 0.03
    (camera 0 frozen). Made on the host from `seed`; `width` 9 adds
    per-camera intrinsics [ds, k1, k2] at zero."""
    from sfm_mvs_tpu_torch.models import ba

    g = torch.Generator().manual_seed(seed)
    K = torch.tensor([[1196.98, 0.0, 466.19], [0.0, 1199.06, 314.13], [0.0, 0.0, 1.0]])
    angles = torch.zeros(C)
    angles[:n_cams] = torch.deg2rad(torch.linspace(-20.0, 20.0, n_cams))
    cams = torch.zeros(C, width)
    cams[:, 1], cams[:, 5] = angles, 8.0
    pts = (torch.rand(P, 3, generator=g) - 0.5) * 4.0
    intr = torch.tensor([1.0, 0.0, 0.0])
    uv = ba._res_grid(cams, pts, torch.zeros(P, C, 2), K, intr)
    uv = uv + 0.3 * torch.randn(P, C, 2, generator=g)
    first = torch.randint(0, n_cams - 1, (P,), generator=g)
    span = torch.randint(2, 9, (P,), generator=g)
    c = torch.arange(C)
    mask = (c >= first[:, None]) & (c < first[:, None] + span[:, None]) & (c < n_cams)
    cams_n = cams.clone()
    cams_n[1:, :3] += 0.01 * torch.randn(C - 1, 3, generator=g)
    cams_n[1:, 3:6] += 0.03 * torch.randn(C - 1, 3, generator=g)
    prob = ba.BAProblem(
        cam_params=cams_n, points=pts + 0.05 * torch.randn(P, 3, generator=g),
        cam_valid=c < n_cams, point_valid=torch.arange(P) < n_points, obs_uv=uv,
        obs_mask=mask, K=K, frozen=c < 1, intr=intr)
    return ba.BAProblem(*(t.to(DEVICE) for t in prob))


def _ba_outputs_equal(a, b) -> bool:
    (pa, sa), (pb, sb) = a, b
    return all(torch.equal(x, y) for x, y in zip(
        (pa.cam_params, pa.points, pa.intr, *sa), (pb.cam_params, pb.points, pb.intr, *sb)))


def _ba_sync_ms(fn, calls=5) -> float:
    """Median synchronized host ms of `calls` calls of fn()."""
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def phase_ba_graph() -> None:
    """Phase 3c: the graph path of ``ba.run_ba`` against the eager loop."""
    from torch.profiler import ProfilerActivity, profile

    from sfm_mvs_tpu_torch.models import ba
    from sfm_mvs_tpu_torch.utils import profiling

    def traced(fn):
        profiling.reset()
        profiling.enable()
        try:
            out = fn()
            return out, profiling.summary(profiling.export())["counters"]
        finally:
            profiling.disable()
            profiling.reset()

    steps = ("ba.lm_steps", "ba.active", "ba.accepted", "ba.cg_steps")
    cases = [
        ("fountain11", (11, 16384, 11, 12000), {}, dict(max_iterations=8, cg_iters=15)),
        ("fountain11-intrinsics", (11, 16384, 11, 12000), {},
         dict(max_iterations=8, cg_iters=15, refine_intrinsics=True)),
        ("fountain11-percam", (11, 16384, 11, 12000), dict(width=9),
         dict(max_iterations=8, cg_iters=15)),
        ("gustav57", (64, 16384, 57, 14000), {}, dict(max_iterations=8, cg_iters=20)),
        ("gustav57-huber", (64, 16384, 57, 14000), {},
         dict(max_iterations=30, cg_iters=20, huber_delta=3.0)),
    ]
    ba._graphs.clear()
    for seed, (name, shape, pkw, kw) in enumerate(cases):
        a = ba_graph_problem(*shape, seed=2 * seed, **pkw)
        b = ba_graph_problem(*shape, seed=2 * seed + 1, **pkw)
        statics = (kw["max_iterations"], kw["cg_iters"], 1e-3, 4.0, 2.0,
                   kw.get("huber_delta", 0.0), kw.get("refine_intrinsics", False))
        torch.cuda.synchronize()
        t = time.perf_counter()
        eager_a, counts_e = traced(lambda: ba.run_ba(a, **kw))  # the key's first call: eager
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        eager_b, counts_eb = traced(lambda: ba.run_ba(b, **kw))  # the second: eager
        torch.cuda.synchronize()
        t = time.perf_counter()
        graph_b, counts_b = traced(lambda: ba.run_ba(b, **kw))  # the third: capture, replay
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t) * 1e3
        kept = [t.clone() for t in (graph_b[0].cam_params, graph_b[0].points, graph_b[0].intr,
                                    *graph_b[1])]
        graph_a, counts_a = traced(lambda: ba.run_ba(a, **kw))  # the fourth: replay
        bitwise = _ba_outputs_equal(eager_a, graph_a) and _ba_outputs_equal(eager_b, graph_b)
        cost_gap = max(abs(float(g[1].final_cost) / float(e[1].final_cost) - 1.0)
                       for e, g in ((eager_a, graph_a), (eager_b, graph_b)))
        if not bitwise and cost_gap > 1e-6:
            raise AssertionError(f"[ba-graph] {name}: graph path differs from the eager loop, "
                                 f"final cost rel {cost_gap:.3g}")
        if [counts_e[k] for k in steps] != [counts_a[k] for k in steps]:
            raise AssertionError(f"[ba-graph] {name}: step counters {counts_e} (eager) "
                                 f"against {counts_a} (graph)")
        after = (graph_b[0].cam_params, graph_b[0].points, graph_b[0].intr, *graph_b[1])
        if not all(torch.equal(x, y) for x, y in zip(kept, after)):
            raise AssertionError(f"[ba-graph] {name}: a later replay changed an earlier "
                                 "call's returned tensors")
        calls = tuple(sum(c.get(k, 0) for c in (counts_e, counts_eb, counts_b, counts_a))
                      for k in ("ba.graph_captures", "ba.graph_replays"))
        if calls != (1, 2):
            raise AssertionError(f"[ba-graph] {name}: captures, replays {calls}, not (1, 2)")
        eager_ms = _ba_sync_ms(lambda: ba._lm_loop(a, *statics, None), calls=3)
        graph_ms = _ba_sync_ms(lambda: ba.run_ba(a, **kw))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ba.run_ba(a, **kw)
            torch.cuda.synchronize()
        launches = sum(1 for e in prof.events()
                       if e.name.startswith("cu") and "LaunchKernel" in e.name)
        graph_launches = sum(1 for e in prof.events() if e.name.startswith("cudaGraphLaunch"))
        log(f"[ba-graph] {name} (C={shape[0]}, P={shape[1]}, {kw}): bitwise "
            f"{bitwise} (final cost rel {cost_gap:.3g}), stats "
            f"{[round(float(v), 6) for v in graph_a[1]]}, counters "
            f"{ {k: int(counts_a[k]) for k in steps} }, captures/replays {calls}; eager "
            f"{eager_ms:.2f} ms, graph {graph_ms:.2f} ms a call, first call (eager) "
            f"{first_ms:.1f} ms, third (capture) {capture_ms:.1f} ms; one replayed call: "
            f"{launches} kernel launches, {graph_launches} graph launch")


def phase_main(imgs, Rt_gt, cfg):
    from sfm_mvs_tpu_torch.models import map_store
    from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM
    from sfm_mvs_tpu_torch.ops import sift

    sfm = IncrementalSfM(cfg, device=DEVICE)
    tracer_start()
    t0 = time.perf_counter()
    state = sfm.run(imgs)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = k1_counts()[0]

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
    from sfm_mvs_tpu_torch.utils import io
    from sfm_mvs_tpu_torch.utils.config import SfmConfig, SweepConfig

    out = "chiprun_out/cli"
    shutil.rmtree(out, ignore_errors=True)
    args = cli_args(out, "--bootstrap", "auto", "--ba", "--ba-iterations", "8", "--finalize",
                    "--sweep", "--sweep-contrast", "0.0025", "--densify", "--no-gif")
    Sfm = incremental.IncrementalSfM
    tracer_start()
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

    n = len(os.listdir(FRAME_DIR))
    n_vals, n_poses, ate = _pose_csv_quality(f"{out}/pose.csv", Rt_gt)
    sparse, _ = io.read_ply(f"{out}/sparse.ply")
    dense, _ = io.read_ply(f"{out}/dense.ply")
    os.remove(f"{out}/dense.ply")  # ~150 MB of ASCII; the copy back holds 64 MiB
    with open(f"{out}/metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    launches = k1_counts()[0]
    events = sorted({r["event"] for r in records})
    boot = next(r for r in records if r["event"] == "bootstrap_auto")
    pair, tries = boot["pair"], 1 + boot["retries"]  # the guard's retries match again
    map_points = next(r["points"] for r in records if r["event"] == "finalize")
    window = SfmConfig().view_graph_window
    graph_pairs = sum(min(window, n - 1 - i) for i in range(n))
    swept = sum(n - s for s in SweepConfig().pair_strides)
    expected = graph_pairs + tries + (n - 2) + swept
    log(f"[cli] rc {rc}; bootstrap pair {tuple(pair)}; pose.csv {n_vals} values "
        f"({n_poses} poses) ATE {ate:.6f}; map points after finalize {map_points}, "
        f"sparse.ply {len(sparse)} vertices; dense.ply {len(dense)} vertices; metrics "
        f"events {events}")
    log(f"[cli] K1 launches {launches} (expected {expected} = {graph_pairs} view-graph "
        f"pairs (window {window}) + {tries} bootstrap tries + {n - 2} registrations + "
        f"{swept} swept pairs)")
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
    from sfm_mvs_tpu_torch.utils import checkpoint

    out = "chiprun_out/resume"
    shutil.rmtree(out, ignore_errors=True)
    args = cli_args(out, "--bootstrap", "seq", "--checkpoint-every", "20", "--no-gif")
    n = len(os.listdir(FRAME_DIR))
    tracer_start()
    t0 = time.perf_counter()
    rc_a = cli.main(args)
    run_a_s = time.perf_counter() - t0
    with open(f"{out}/pose.csv", "rb") as fh:
        pose_a = fh.read()
    launches = k1_counts()[0]
    latest = checkpoint.latest_checkpoint(f"{out}/checkpoints")
    tracer_start()
    t0 = time.perf_counter()
    rc_b = cli.main(args + ["--resume"])
    run_b_s = time.perf_counter() - t0
    with open(f"{out}/pose.csv", "rb") as fh:
        pose_b = fh.read()
    launches += k1_counts()[0]
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
    """Records the arguments and return values of a module function while
    active."""

    def __init__(self, owner, name):
        self.owner, self.name, self.values, self.calls = owner, name, [], []

    def __enter__(self):
        fn = self.fn = getattr(self.owner, self.name)

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.values.append(out)
            self.calls.append((args, kwargs))
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

    out = "chiprun_out/loop"
    shutil.rmtree(out, ignore_errors=True)
    args = cli_args(out, "--bootstrap", "seq", "--essential-solver", "5pt", "--grad-sampling",
                    "bilinear", "--ba", "--ba-iterations", "8", "--loop-close", "4",
                    "--finalize", "--no-gif")
    Sfm = incremental.IncrementalSfM
    tracer_start()
    t0 = time.perf_counter()
    with StageClock([(native.ImageLoader, "get", "image load"), (Sfm, "run", "run"),
                     (Sfm, "finalize", "finalize"),
                     (exhaustive, "build_view_graph", "view graph"),
                     (exhaustive, "inject_reobservations", "injection")]) as clock, \
            Capture(exhaustive, "strongest_loop_pairs") as pairs:
        rc = cli.main(args)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0

    n = len(os.listdir(FRAME_DIR))
    n_vals, n_poses, ate = _pose_csv_quality(f"{out}/pose.csv", Rt_gt)
    with open(f"{out}/metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    launches = k1_counts()[0]
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


def phase_intrinsics(cfg, renders):
    """Phase 11: the staircase rendered with radial distortion (k1, k2) =
    (-0.18, 0.03), reconstructed by a driver unaware of it (BA off), then
    the shared-intrinsics BA (the full-size twin of
    tests/test_distortion.py's k1 recovery) and the per-camera variant."""
    from sfm_mvs_tpu_torch.models import ba
    from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM

    (imgs, Rt_gt, _), render_s = renders.get("distorted")
    # BA off, as in the test this mirrors: a per-frame pinhole BA absorbs
    # most of the distortion into the structure first (PERF.md, section 4).
    sfm = IncrementalSfM(cfg, device=DEVICE)
    tracer_start()
    t0 = time.perf_counter()
    state = sfm.run(imgs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = k1_counts()[0]
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
    log(f"[intr] distorted render waited {render_s:.1f} s; run, BA off (k1 = k2 = 0 assumed): cameras "
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
    from sfm_mvs_tpu_torch.utils.synthetic import render_plane_sequence

    imgs, Rt_gt, _ = render_plane_sequence(**PLANE)
    F = len(imgs)
    tracer_start()
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
    launches = k1_counts()[0]
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


# The JAX package's KltSfM on phase 4's frames and config (redetect_every=5),
# on a CPU (``scripts/torch_port_records.py klt``): its LK conditioning gate
# (min eigenvalue 1e-4 per pixel) keeps 4 of frame 1's 424 features at
# 968x648, so it registers 2/57 (ROADMAP C4).
KLT_RECORD = dict(cameras=2, points=335, ate=4.77093641854673e-07, rot=0.0, tracked_min=0,
                  pnp_min=0, reproj_max=1.8561153411865234)
# tests/test_klt_pipeline.py's bounds: (record key, bound, higher is better)
KLT_BOUNDS = dict(cameras=(57, True), ate=(0.06, False), rot=(1.5, False),
                  tracked_min=(80, True), pnp_min=(30, True), reproj_max=(1.0, False))


def _klt_gate(key, value):
    """(passes, gate text): the test's bound where the JAX record meets it,
    else no worse than the record by more than 20%."""
    bound, higher = KLT_BOUNDS[key]
    rec = KLT_RECORD[key]
    if (rec > bound) if higher else (rec < bound):
        return ((value > bound) if higher else (value < bound)), f"{'>' if higher else '<'} {bound}"
    lim = 0.8 * rec if higher else 1.2 * rec
    return ((value >= lim) if higher else (value <= lim)), (
        f"{'>=' if higher else '<='} {lim:.6g} (JAX record {rec:.6g} misses {bound})")


def phase_klt(imgs, Rt_gt, cfg):
    """Phase 13: ``KltSfM(cfg, redetect_every=5, device="cuda")`` on phase
    4's frames; gates from tests/test_klt_pipeline.py and the JAX record."""
    from sfm_mvs_tpu_torch.models.klt import KltSfM
    from sfm_mvs_tpu_torch.utils import evaluate

    tracer_start()
    t0 = time.perf_counter()
    k = KltSfM(cfg, redetect_every=5, device=DEVICE)
    state = k.run(imgs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1_counts()[0]
    cv = state.cam_valid.cpu().numpy()
    poses = state.poses.cpu().numpy()[cv]
    n = len(poses)
    got = dict(cameras=n, points=int(state.num_points),
               ate=float(evaluate.ate_rmse(poses, Rt_gt[:n])),
               rot=float(evaluate.rotation_errors_deg(poses, Rt_gt[:n]).max()),
               tracked_min=min(s["tracked"] for s in k.stats),
               pnp_min=min(s["pnp_inliers"] for s in k.stats),
               reproj_max=max(s["reproj_error"] for s in k.stats))
    log(f"[klt] cameras {n}/{len(imgs)} points {got['points']} ATE {got['ate']:.6g} "
        f"max_rot_err_deg {got['rot']:.4f}; per frame: tracked min {got['tracked_min']} "
        f"(max {max(s['tracked'] for s in k.stats)}), pnp_inliers min {got['pnp_min']}, "
        f"reproj_px max {got['reproj_max']:.4f}; {wall:.1f} s "
        f"({wall / (len(imgs) - 2) * 1e3:.1f} ms per tracked frame, synchronized host clock); "
        f"K1 launches {launches} (expected 1)")
    log(f"[klt] JAX CPU record: {json.dumps(KLT_RECORD)}")
    with open("chiprun_out/chip_smoke_klt.json", "w") as fh:
        json.dump({"summary": got, "wall_s": wall, "stats": k.stats}, fh)
    for key in KLT_BOUNDS:
        ok, text = _klt_gate(key, got[key])
        if not ok:
            raise AssertionError(f"KLT {key} {got[key]} fails its gate {text}")
    if not got["points"] >= 0.8 * KLT_RECORD["points"]:
        raise AssertionError(f"KLT points {got['points']} < 0.8 x the JAX record's")
    if launches != 1:
        raise AssertionError(f"K1 launched {launches} times, expected 1 (the bootstrap)")
    return launches


LARGE = dict(num_cameras=250, image_size=(480, 360), focal=600.0, radius=9.0,
             arc_degrees=145.0, num_strips=12, depth_spread=2.0)
STITCH_BATCH = 32


def chunk_pairs(pairs, batch):
    """benchmarks/large_scene.py:63-81: chunks of at most `batch` pairs whose
    i are distinct and whose j are distinct."""
    chunks = []
    for p in pairs:
        for c in chunks:
            if len(c) < batch and all(p[0] != q[0] and p[1] != q[1] for q in c):
                c.append(p)
                break
        else:
            chunks.append([p])
    return chunks


def phase_stitch(renders):
    """Phase 14: benchmarks/large_scene.py's split-phase stitching at its
    full width: 250 frames registered by ``IncrementalSfM`` with windowed BA,
    covisibility retrieval, match + batched E-RANSAC once per pair, both
    directions applied, then the finalize with the candidates re-applied
    after each robust BA round."""
    import dataclasses

    from sfm_mvs_tpu_torch.models import ba, exhaustive, map_store
    from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM
    from sfm_mvs_tpu_torch.models.refine import finalize_map
    from sfm_mvs_tpu_torch.ops.sift import Features
    from sfm_mvs_tpu_torch.utils.config import (
        BaConfig, FrontendConfig, MapConfig, RansacConfig, SfmConfig,
    )

    (imgs, Rt_gt, _), render_s = renders.get("large")
    F = len(imgs)
    W, H = LARGE["image_size"]
    f = LARGE["focal"]
    cfg = SfmConfig(
        fx=f, fy=f, cx=W / 2.0, cy=H / 2.0, downscale=1,
        frontend=FrontendConfig(max_features=2048, num_octaves=4, upsample_input=True,
                                contrast_threshold=0.012, lowe_ratio=0.75),
        ransac=RansacConfig(essential_iters=1024, pnp_iters=1024),
        map=MapConfig(max_cameras=256, max_points=131072),
        ba=BaConfig(enabled=True, local_window=32, max_iterations=6))
    cfg_stitch = dataclasses.replace(cfg, ransac=dataclasses.replace(cfg.ransac,
                                                                     essential_iters=512))
    sfm = IncrementalSfM(cfg, device=DEVICE)
    tracer_start()
    t0 = time.perf_counter()
    state = sfm.run(imgs)
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    reg_launches = k1_counts()[0]
    reg_map = state
    n_cams, ate_reg, _ = _pose_quality(state, Rt_gt)
    if n_cams != F:
        raise AssertionError(f"stitch scene: registered {n_cams}/{F} cameras")
    if reg_launches != F - 1:
        raise AssertionError(f"K1 launched {reg_launches} times in registration, expected {F - 1}")

    # The stitch, once after registration (camera i is frame i).
    tracer_start()
    t0 = time.perf_counter()
    cnt = exhaustive.covisibility_matrix(state, image_size=(W, H)).cpu().numpy()
    pairs = exhaustive.retrieve_stitch_pairs(
        cnt, n_cams, min_gap=8, min_covis=48,
        octaves=((8, 16), (16, 32), (32, 64), (64, 128), (128, 1 << 30)))
    pairs = [(i, j) for i, j in pairs if j % 2 == 0]  # large_scene.py:314

    def stack(rows):
        return Features(*[torch.stack(col) for col in zip(*rows)])

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)
    gate = cfg.map.stitch_gate_px
    cache, injected, reapply_first = [], 0, None
    feats, tracks = sfm._cam_feats, sfm._cam_tracks
    for c in chunk_pairs(pairs, STITCH_BATCH):
        nb = len(c)
        cp = c + [c[-1]] * (STITCH_BATCH - nb)
        ii, jj = [i for i, _ in cp], [j for _, j in cp]
        cand = exhaustive.stitch_candidates_batch(
            state, torch.tensor(ii, device=DEVICE), torch.tensor(jj, device=DEVICE),
            stack([feats[i] for i in ii]), stack([feats[j] for j in jj]),
            torch.stack([tracks[i] for i in ii]), torch.stack([tracks[j] for j in jj]),
            torch.arange(STITCH_BATCH) < nb, cfg_stitch, gen=gen)
        cache.append(cand)
        state, ca = exhaustive.apply_stitch_batch(state, cand.cam_a, cand.tids_a, cand.uv_a,
                                                  cand.ok, gate)
        state, cb = exhaustive.apply_stitch_batch(state, cand.cam_b, cand.tids_b, cand.uv_b,
                                                  cand.ok, gate)
        injected += int(ca.sum() + cb.sum())
        if reapply_first is None:  # the same candidates again inject nothing
            state, ra = exhaustive.apply_stitch_batch(state, cand.cam_a, cand.tids_a,
                                                      cand.uv_a, cand.ok, gate)
            state, rb = exhaustive.apply_stitch_batch(state, cand.cam_b, cand.tids_b,
                                                      cand.uv_b, cand.ok, gate)
            reapply_first = int(ra.sum() + rb.sum())
    torch.cuda.synchronize()
    stitch_s = time.perf_counter() - t0
    stitch_launches, batches, rows = k1_counts()

    # The finalize: compact, shrink, robust BA <-> re-apply, polish.
    t0 = time.perf_counter()
    P_old = state.points.shape[0]
    state, remap = map_store.compact_points(state)
    live = int(state.num_points)
    cap = 8192
    while cap < live:
        cap *= 2
    state = map_store.shrink_map(state, cap)

    def remap_tids(t):
        return torch.where(t >= 0, remap[torch.clamp(t, 0, P_old - 1).long()],
                           torch.full_like(t, -1))

    cache = [c._replace(tids_a=remap_tids(c.tids_a), tids_b=remap_tids(c.tids_b)) for c in cache]
    robust, reinjected = [], 0
    for _ in range(2):
        state, stats = ba.bundle_adjust_map(state, max_iterations=40, cg_iters=30,
                                            huber_delta=3.0)
        robust.append(float(stats.final_cost))
        for cand in cache:
            state, ca = exhaustive.apply_stitch_batch(state, cand.cam_a, cand.tids_a,
                                                      cand.uv_a, cand.ok, gate)
            state, cb = exhaustive.apply_stitch_batch(state, cand.cam_b, cand.tids_b,
                                                      cand.uv_b, cand.ok, gate)
            reinjected += int(ca.sum() + cb.sum())
    state, fin = finalize_map(state, max_iterations=15)
    torch.cuda.synchronize()
    fin_s = time.perf_counter() - t0
    n_fin, ate, rot = _pose_quality(state, Rt_gt)
    final_cost = fin["round1_cost"]
    log(f"[stitch] scene {F} frames {LARGE['image_size']}, render waited {render_s:.1f} s; "
        f"registration (IncrementalSfM, window BA 32 cams, 6 iterations) {n_cams}/{F} "
        f"cameras, ATE {ate_reg:.6f}, {reg_s:.1f} s, K1 launches {reg_launches}")
    log(f"[stitch] covisibility + retrieval: {len(pairs)} pairs in "
        f"{len(cache)} chunks of <= {STITCH_BATCH}; injected {injected} observations; "
        f"re-apply right after {reapply_first}; {stitch_s:.2f} s; K1 batched launches {batches} "
        f"(expected {len(cache)}, one per chunk) matching {rows} pair rows ({len(pairs)} live "
        f"+ pads), single launches {stitch_launches} (expected 0)")
    log(f"[stitch] finalize: capacity {cap} ({live} live), robust costs "
        f"{robust[0]:.4f} / {robust[1]:.4f} px^2, re-applied {reinjected}, final cost "
        f"{final_cost:.4f} px^2, cameras {n_fin}/{F}, ATE {ate:.6f} (v5e record 0.02425, "
        f"interleaved), max_rot_err_deg {rot:.4f}; {fin_s:.2f} s")
    if n_fin != F:
        raise AssertionError(f"stitch: {n_fin}/{F} cameras after finalize")
    if not ate < 0.05:
        raise AssertionError(f"stitch: ATE {ate} >= 0.05")
    if not (pairs and injected > 0):
        raise AssertionError(f"stitch: {len(pairs)} pairs, {injected} injected")
    if reapply_first != 0:
        raise AssertionError(f"stitch: re-applying the first chunk injected {reapply_first}")
    if not final_cost < 1.0:
        raise AssertionError(f"stitch: final cost {final_cost} >= 1 px^2")
    if (stitch_launches, batches, rows) != (0, len(cache), STITCH_BATCH * len(cache)):
        raise AssertionError(f"K1 in the stitch: {stitch_launches} single and {batches} batched "
                             f"launches over {rows} rows, expected 0, {len(cache)} and "
                             f"{STITCH_BATCH * len(cache)}")
    return reg_launches, batches, reg_map


MVS_RECORD = dict(rel_rms=0.01421, median=0.00299, under_1pct=0.8919, coverage_gt=0.8008,
                  points=5353610)  # artifacts/MVS_r05.json (v5e; quality only)
# benchmarks/mvs_full.py's densify_map settings (the GT harness).
# zero-mean + sweep launches a pass-1 chunk: one each a pyramid level.
MVS_LAUNCHES_A_CHUNK = 6
MVS_SETTINGS = dict(num_depths=64, stride=2, geo_rel_tol=0.02, edge_trim_radius=6,
                    geo_min_consistent=2, free_space_rel=0.05, min_conf=0.5)


def depth_gates(depth, gt_depths, s_align):
    """(rel-RMS, median, share under 1%, coverage of GT-valid pixels) of the
    filtered depth maps [(frame, depth, valid)] against the renderer's
    depths (GT > 0.1), after scaling by the Umeyama scale s_align."""
    rels, covs_gt = [], []
    for r, d, valid in depth:
        d_est = d * s_align
        d_gt = gt_depths[r]
        gt_ok = d_gt > 0.1
        ok = valid & gt_ok
        covs_gt.append(ok.sum() / max(gt_ok.sum(), 1))
        rels.append(np.abs(d_est[ok] - d_gt[ok]) / d_gt[ok])
    rel = np.concatenate(rels)
    return (float(np.sqrt(np.mean(rel ** 2))), float(np.median(rel)), float(np.mean(rel < 0.01)),
            float(np.mean(covs_gt)))


def phase_mvs(stack8, state, Rt_gt, gt_depths):
    """benchmarks/mvs_full.py's recipe on phase 5's map before its sweep;
    every chunk's pass 1 must go through the MVS kernels. Returns (map,
    points, scale, MVS kernel launches)."""
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
    tracer_start()
    with StageClock([(mvs, "_depth_ranges", "pass 1"), (mvs, "_plane_sweep_batch", "pass 1"),
                     (mvs, "_fuse_batch", "pass 2")]) as clock:
        pts, _, dms = mvs.densify_map(grays, state, **MVS_SETTINGS, images_bgr=bgrs,
                                      return_depth_maps=True)
    launches = mvs_kernel_count()
    chunks = -(-int(state.num_cams) // 4)
    depth = [(r, dm.depth.cpu().numpy(), dm.valid.cpu().numpy()) for r, dm in dms.items()]
    rms, med, under, cov = depth_gates(depth, gt_depths, s_align)
    rec = MVS_RECORD
    log(f"[mvs] depth rel-RMS {rms:.5f} (v5e record: {rec['rel_rms']})  median {med:.5f} "
        f"(v5e record: {rec['median']})  under 1% {under:.4f} (v5e record: {rec['under_1pct']})")
    log(f"[mvs] coverage of GT-valid pixels {cov:.4f} (v5e record: {rec['coverage_gt']})  "
        f"dense points {len(pts)} (v5e record: {rec['points']})  scale {s_align:.5f}")
    log(f"[mvs] pass 1 {clock.total('pass 1'):.2f} s, pass 2 {clock.total('pass 2'):.2f} s "
        f"(synchronized host clock, {n} reference frames, batches of 4); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; MVS kernel launches {launches} "
        f"({chunks} chunks)")
    if launches != MVS_LAUNCHES_A_CHUNK * chunks:
        raise AssertionError(f"{launches} MVS kernel launches in densify_map, expected "
                             f"{MVS_LAUNCHES_A_CHUNK} x {chunks} chunks")
    if not med < 0.01 or not rms < 0.03:
        raise AssertionError(f"depth error median {med} / rel-RMS {rms} above 0.01 / 0.03")
    if not cov > 0.65:
        raise AssertionError(f"coverage of GT-valid pixels {cov} <= 0.65")
    if not np.isfinite(pts).all():
        raise AssertionError("non-finite dense points")
    return state, pts, s_align, launches


# MVS pass 1's kernels (ops/mvs_cuda.py) on two chunks of 4 references,
# each with its 4 sweep neighbours, ground-truth poses and depth ranges from
# the rendered depths (densify_map's quantiles and widening): portbench's
# fountain11 scene at 1536x1024 (references 4-7), where every level is a
# whole number of 32-px tiles, and the staircase scene at 968x648
# (references 10-13), where every level ends in ragged
# tiles (the clamped halo and the out-of-image guards), as phase 9, the
# CLI's --densify and the distributed MVS run. The yardstick is the plain
# code run in float64 on the same float32 inputs; the plain code in
# float32 (the path the kernels replace) is held to it too, and the kernels
# may disagree with float64 no more than it does.
MVS_CHUNK = [4, 5, 6, 7]
STAIR_CHUNK = [10, 11, 12, 13]
MVS_DIST = (0.03, -0.01)
SWEEP_REL = 1e-5  # relative cost tolerance, and the cost gap that makes a choice clear
COST_FLOOR = 1e-3  # costs below it are compared absolutely, to SWEEP_REL * COST_FLOOR
FLIP_REL = 1e-4  # a cost this far off float64 has a tap on another pixel (rounding: < 2e-7)


def _chunk_of(images, Rt, K, depths, refs):
    """(refs, nbrs, poses, nbr poses, K, lo, hi) of the references `refs`
    of a rendered scene (tensors on the card), neighbours r-2..r+2."""
    idx = torch.as_tensor(refs, device=DEVICE)
    nidx = torch.as_tensor([[r - 2, r - 1, r + 1, r + 2] for r in refs], device=DEVICE)
    poses = torch.as_tensor(Rt, dtype=torch.float32, device=DEVICE)
    q = torch.tensor([0.02, 0.98], device=DEVICE)
    lohi = torch.stack([torch.quantile(z[z > 0.1], q) for z in depths[idx].flatten(1)])
    return (images[idx].contiguous(), images[nidx].contiguous(), poses[idx], poses[nidx],
            torch.as_tensor(K, dtype=torch.float32, device=DEVICE), lohi[:, 0] * 0.7,
            lohi[:, 1] * 1.4)


def _mvs_chunk():
    """The fountain chunk (1536x1024)."""
    from portbench import scene as pscene

    with open("portbench/configs/fountain11.json") as fh:
        s = json.load(fh)["scene"]
    sc = pscene.render(s["num_cameras"], s["image_size"], s["fx"], s["fy"], s["cx"], s["cy"],
                       s["radius"], s["arc_degrees"], s["num_strips"], s["depth_spread"],
                       s["geometry_seed"], texture_seed=1, device=DEVICE)
    return _chunk_of(sc.images, sc.Rt, sc.K, sc.depths, MVS_CHUNK)


def _stair_chunk(imgs, Rt_gt, K, gt_depths):
    """The staircase chunk (968x648), its frames as the main path stages
    them (uint8 on the card, / 255)."""
    return _chunk_of(stage_u8(imgs).float() / 255.0, Rt_gt, K,
                     torch.as_tensor(np.asarray(gt_depths), device=DEVICE), STAIR_CHUNK)


def _f64(x):
    return x.double() if torch.is_tensor(x) else x


def _volume(fn, args, kw):
    """(costs, dens), each (B, D + E, H, W): every hypothesis of a level,
    one `fn` call each (`fn` is ``_sweep_select_plain`` or the kernel's
    wrapper). A lone hypothesis's best cost is its cost and its den_best
    its den; an escape map is a center with offset 0."""
    ref_zm, nbrs_zm, Kl, R, t, center, offs, radius = args
    one = dict(dist=kw.get("dist"), sample_mode=kw.get("sample_mode", "bilinear"))
    outs = [fn(ref_zm, nbrs_zm, Kl, R, t, center, offs[:, d:d + 1].contiguous(), radius, **one)
            for d in range(offs.shape[1])]
    zero = torch.zeros_like(offs[:, :1])
    outs += [fn(ref_zm, nbrs_zm, Kl, R, t, e, zero, radius, **one) for e in kw.get("extra", ())]
    return torch.stack([o[1] for o in outs], 1), torch.stack([o[3] for o in outs], 1)


def _sweep_readings(args, kw, kernel_out) -> dict:
    """The kernel's and the float32 plain code's disagreement with the
    float64 plain code on one level's inputs, from their outputs and from
    each one's cost of every hypothesis."""
    from sfm_mvs_tpu_torch.models import mvs
    from sfm_mvs_tpu_torch.ops import mvs_cuda

    a64 = [_f64(x) for x in args]
    kw64 = dict(kw, dist=_f64(kw.get("dist")), extra=tuple(_f64(e) for e in kw.get("extra", ())))
    ref = mvs._sweep_select_plain(*a64, **kw64)
    c64, _ = _volume(mvs._sweep_select_plain, a64, kw64)
    offs = args[6]
    D = offs.shape[1]
    srt = c64.sort(1).values
    scale = srt[:, 0].abs().clamp_min(COST_FLOOR)
    clear = (srt[:, 1] - srt[:, 0] > SWEEP_REL * scale if c64.shape[1] > 1
             else torch.ones_like(scale, dtype=torch.bool))
    best = c64.argmin(1)
    step = ((offs[:, 1] - offs[:, 0]) if D > 1 else torch.ones_like(offs[:, 0])).double()
    # The edge band: the ragged last tile column and row (the kernel's
    # out-of-image guards) and the pixels within the filter's radius of the
    # image's border (its clamped halo).
    H, W, rad = args[0].shape[-2], args[0].shape[-1], args[7]
    ys = torch.arange(H, device=DEVICE)[:, None]
    xs = torch.arange(W, device=DEVICE)[None, :]
    band = ((xs >= W // mvs_cuda.TILE * mvs_cuda.TILE) | (ys >= H // mvs_cuda.TILE * mvs_cuda.TILE)
            | (xs < rad) | (ys < rad) | (xs >= W - rad) | (ys >= H - rad))
    out = {"clear": float(clear.double().mean()),
           "cost_median": float(srt[:, 0].median()),
           "flat": float((srt[:, 0] < COST_FLOOR).double().mean()),
           "band": float(band.double().mean())}
    paths = {"kernel": (kernel_out, mvs_cuda.sweep_select),
             "plain32": (mvs._sweep_select_plain(*args, **kw), mvs._sweep_select_plain)}
    vols = {name: _volume(fn, args, kw) for name, (_, fn) in paths.items()}
    rels = {name: (c.double() - c64).abs() / c64.abs().clamp_min(COST_FLOOR)
            for name, (c, _) in vols.items()}
    # Pixels where both paths' cost of some hypothesis is more than
    # FLIP_REL off float64: a discrete tap (nearest, or the inside test)
    # that float32 and float64 round to different pixels. Both paths warp
    # with the same float32 roundings, so they share these errors; the mean
    # of the D costs carries any one of them.
    shared = ((rels["kernel"] > FLIP_REL) & (rels["plain32"] > FLIP_REL)).any(1)
    out["shared_flips"] = float(shared.double().mean())
    for name, (o, fn) in paths.items():
        c, d = vols[name]
        r = {}
        rel4 = rels[name]
        rel = rel4.flatten()
        r["edge_median"] = float(rel4[..., band].median())
        r["edge_over"] = float((rel4[..., band] > SWEEP_REL).double().mean())
        r["vol_median"] = float(rel.median())
        r["vol_p99"] = float(torch.quantile(rel[::rel.numel() // (1 << 23) + 1], 0.99))
        r["vol_over"] = float((rel > SWEEP_REL).double().mean())
        for key, i in (("best", 1), ("mean", 2)):
            e = ((o[i].double() - ref[i]).abs() / ref[i].abs().clamp_min(COST_FLOOR)).flatten()
            r[f"{key}_median"] = float(e.median())
            r[f"{key}_over"] = float((e > SWEEP_REL).double().mean())
            r[f"{key}_abs"] = float(e.mean())
            r[f"{key}_over_unshared"] = float(((e > SWEEP_REL) & ~shared.flatten()).double().mean())
        chose = c.argmin(1)
        r["choice_miss"] = float((chose != best)[clear].double().mean())
        r["edge_miss"] = int((chose != best)[clear & band].sum())
        # The selection against the path's own costs, exactly: the best cost,
        # its den, and the mean as the kernel sums it (in order, compensated
        # (Kahan), then / D).
        r["sel_best"] = float((o[1] != c.min(1).values).double().mean())
        r["sel_den"] = float((o[3] != d.gather(1, chose[:, None])[:, 0]).double().mean())
        acc, comp = torch.zeros_like(c[:, 0]), torch.zeros_like(c[:, 0])
        for j in range(D):
            y = c[:, j] - comp
            t = acc + y
            comp = (t - acc) - y
            acc = t
        # (float64 quotient, rounded once: IEEE float32 division; CUDA's
        # tensor / scalar multiplies by the reciprocal instead.)
        r["sel_mean"] = float((o[2] != (acc.double() / D).float()).double().mean())
        # invd where the choice is clear (elsewhere the costs tie, or differ
        # below float32's resolution, and any hypothesis is as good).
        dv = ((o[0].double() - ref[0]).abs() / step[:, None, None])[clear]
        r["invd_far"] = float((dv > 0.5).double().mean())
        same = (chose == best)[clear]
        r["invd_same"] = float(dv[same].max()) if same.any() else 0.0
        out[name] = r
    return out


def _sweep_taps(levels) -> int:
    """Neighbour taps a sweep call needs: per level B x M x H x W x
    hypotheses x (1 nearest, 4 bilinear)."""
    n = 0
    for args, kw in levels:
        ref_zm, nbrs_zm, offs = args[0], args[1], args[6]
        taps = 1 if kw.get("sample_mode") == "nearest" else 4
        n += nbrs_zm.shape[:2].numel() * ref_zm.shape[-2:].numel() * taps * (
            offs.shape[1] + len(kw.get("extra", ())))
    return n


def _plain_pass1():
    """Context: mvs's pass 1 routed to the plain code (for timing it)."""
    from unittest import mock

    from sfm_mvs_tpu_torch.models import mvs

    return mock.patch.multiple(mvs, _sweep_select=mvs._sweep_select_plain,
                               _zero_mean=mvs._zero_mean_plain)


def _pass1_paths(sweep) -> dict:
    """One pass-1 call `sweep()` through the kernels and through the plain
    code: launch-amortized ms (CUDA events), the kernels' launches a call
    (the tracer's ``mvs.sweep_kernel``), and each path's device ops and
    busy ms under torch.profiler."""
    out = {}
    tracer_start()
    sweep()
    out["kernel_launches"] = mvs_kernel_count()
    out["kernel_ms"] = statistics.median(_window_ms(sweep, calls=20, windows=5))
    _, out["kernel_busy_ms"], out["kernel_ops"], _ = _profile_window(sweep)
    with _plain_pass1():
        out["plain_ms"] = statistics.median(_window_ms(sweep, calls=2, windows=3))
        _, out["plain_busy_ms"], out["plain_ops"], _ = _profile_window(sweep)
    return out


def _check_chunk(name, chunk, dist, fails) -> tuple:
    """The card check of one chunk, pinhole and with `dist`: every level's
    readings (logged; failures appended to `fails`). Returns the sweep's
    {(tag, level): (args, kw)} and the zero-mean calls of the pinhole run."""
    from sfm_mvs_tpu_torch.models import mvs

    refs, nbrs, poses, nposes, K, lo, hi = chunk
    levels, zm_calls = {}, None
    for d in (None, dist):
        tag = f"{name} {'dist' if d is not None else 'pinhole'}"
        tracer_start()
        with Capture(mvs, "_sweep_select") as sel, Capture(mvs, "_zero_mean") as zm:
            mvs._plane_sweep_batch(refs, nbrs, poses, nposes, K, lo, hi, dist=d)
        torch.cuda.synchronize()
        n = mvs_kernel_count()
        if n != MVS_LAUNCHES_A_CHUNK:
            fails.append(f"{tag}: {n} kernel launches in one _plane_sweep_batch, expected "
                         f"{MVS_LAUNCHES_A_CHUNK}")
        for lev, ((args, kw), out) in zip((2, 1, 0), zip(sel.calls, sel.values)):
            levels[(tag, lev)] = (args, kw)
            rd = _sweep_readings(args, kw, out)
            k, p = rd["kernel"], rd["plain32"]
            H, W = args[0].shape[-2:]
            log(f"[mvs-kernel] {tag} level {lev} ({W}x{H}, {args[6].shape[1]}+"
                f"{len(kw.get('extra', ()))} hyps, {kw.get('sample_mode', 'bilinear')}): "
                f"float64 best cost median {rd['cost_median']:.4g}, below {COST_FLOOR:g} "
                f"{rd['flat']:.4f}, clear choices {rd['clear']:.4f}; kernel / plain float32 "
                f"against float64:")
            log(f"[mvs-kernel]   every hypothesis's cost: rel err median {k['vol_median']:.3g} / "
                f"{p['vol_median']:.3g}, p99 {k['vol_p99']:.3g} / {p['vol_p99']:.3g}, share > "
                f"{SWEEP_REL:g} {k['vol_over']:.4g} / {p['vol_over']:.4g}")
            log(f"[mvs-kernel]   edge band ({rd['band']:.4f} of pixels: ragged tiles, border): "
                f"rel err median {k['edge_median']:.3g} / {p['edge_median']:.3g}, share > "
                f"{SWEEP_REL:g} {k['edge_over']:.4g} / {p['edge_over']:.4g}, clear choices "
                f"differing {k['edge_miss']} / {p['edge_miss']} pixels")
            for key in ("best", "mean"):
                log(f"[mvs-kernel]   {key}_cost rel err median {k[key + '_median']:.3g} / "
                    f"{p[key + '_median']:.3g}, mean {k[key + '_abs']:.4g} / {p[key + '_abs']:.4g}, "
                    f"share > {SWEEP_REL:g} {k[key + '_over']:.4g} / {p[key + '_over']:.4g}, "
                    f"outside the shared tap flips ({rd['shared_flips']:.4f} of pixels) "
                    f"{k[key + '_over_unshared']:.4g} / {p[key + '_over_unshared']:.4g}")
            log(f"[mvs-kernel]   where clear: chosen hypothesis differs {k['choice_miss']:.4g} / "
                f"{p['choice_miss']:.4g}; invd off by > half a step {k['invd_far']:.4g} / "
                f"{p['invd_far']:.4g}, at most {k['invd_same']:.3g} / {p['invd_same']:.3g} steps "
                f"where the choice is the same")
            log(f"[mvs-kernel]   selection against its own costs: best cost {k['sel_best']:.3g} / "
                f"{p['sel_best']:.3g}, den {k['sel_den']:.3g} / {p['sel_den']:.3g}, mean "
                f"{k['sel_mean']:.3g} / {p['sel_mean']:.3g} of pixels differing")
            for key in ("vol", "edge", "best", "mean"):
                if not k[key + "_median"] <= SWEEP_REL:
                    fails.append(f"{tag} level {lev}: {key} cost median rel err "
                                 f"{k[key + '_median']:.3g} > {SWEEP_REL:g}")
                # The mean's share over SWEEP_REL is dominated by the shared tap
                # flips, where both paths carry the same error and rounding
                # noise decides at the threshold: there it is compared outside
                # them, and its mean error over the whole image besides.
                over = key + ("_over_unshared" if key == "mean" else "_over")
                if not k[over] <= p[over]:
                    fails.append(f"{tag} level {lev}: {key} cost share over {SWEEP_REL:g} "
                                 f"({over}) {k[over]:.4g} > float32 plain {p[over]:.4g}")
            if not k["mean_abs"] <= p["mean_abs"]:
                fails.append(f"{tag} level {lev}: mean cost mean rel err {k['mean_abs']:.4g} > "
                             f"float32 plain {p['mean_abs']:.4g}")
            for key in ("choice_miss", "invd_far"):
                if not k[key] <= p[key]:
                    fails.append(f"{tag} level {lev}: {key} {k[key]:.4g} > float32 plain "
                                 f"{p[key]:.4g}")
            if k["sel_best"] or k["sel_den"] or k["sel_mean"]:
                fails.append(f"{tag} level {lev}: the kernel's selection disagrees with its own "
                             f"costs ({k['sel_best']}, {k['sel_den']}, {k['sel_mean']})")
        for lev, ((args, _), out) in zip((0, 1, 2), zip(zm.calls, zm.values)):
            ref = mvs._zero_mean_plain(*[_f64(a) for a in args])
            plain = mvs._zero_mean_plain(*args)
            ek = max(float((o.double() - r).abs().max()) for o, r in zip(out, ref))
            ep = max(float((o.double() - r).abs().max()) for o, r in zip(plain, ref))
            log(f"[mvs-kernel] {tag} zero-mean level {lev} {tuple(args[0].shape[-2:])}: max abs "
                f"err vs float64 kernel {ek:.3g}, plain float32 {ep:.3g}")
            if not (ek <= 1e-6 and ek <= ep):
                fails.append(f"{tag} zero-mean level {lev}: max abs err {ek:.3g} (plain {ep:.3g})")
        if zm_calls is None:
            zm_calls = zm.calls
    return levels, zm_calls


def phase_mvs_kernel(sweep_regs, stair) -> dict:
    """MVS pass 1's kernels on the card against the float64 plain code, at
    each level of the fountain chunk and of the staircase chunk `stair`
    (``_stair_chunk``), each pinhole and once more with `dist`; then each
    kernel's time per launch and the whole pass 1 of the fountain chunk
    through the kernels and through the plain code."""
    from sfm_mvs_tpu_torch.models import mvs
    from sfm_mvs_tpu_torch.ops import mvs_cuda

    refs, nbrs, poses, nposes, K, lo, hi = fountain = _mvs_chunk()
    dist = torch.tensor(MVS_DIST, device=DEVICE)
    fails = []
    levels, zm_calls = _check_chunk("fountain", fountain, dist, fails)
    _check_chunk("staircase", stair, dist, fails)

    # Times: each launch alone (CUDA events, launch-amortized), then pass 1
    # of the chunk through the kernels and through the plain code.
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lane_rate = sms * 32 * clock_hz  # one 4-byte load per lane per SM cycle
    per_level = {}
    for lev in (2, 1, 0):
        args, kw = levels[("fountain pinhole", lev)]
        ms = statistics.median(_window_ms(lambda: mvs_cuda.sweep_select(*args, **kw), calls=20))
        per_level[lev] = ms
        bound = _sweep_taps([(args, kw)]) / lane_rate * 1e3
        log(f"[mvs-kernel] sweep level {lev}: {ms:.4f} ms a launch; its taps at one load a "
            f"lane a cycle {bound:.4f} ms (share {bound / ms:.3f})")
    zm_ms = sum(statistics.median(_window_ms(lambda: mvs_cuda.zero_mean(*a), calls=20))
                for a, _ in zm_calls)
    taps = _sweep_taps([levels[("fountain pinhole", lev)] for lev in (2, 1, 0)])
    bound = taps / lane_rate * 1e3
    paths = _pass1_paths(lambda: mvs._plane_sweep_batch(refs, nbrs, poses, nposes, K, lo, hi))
    log(f"[mvs-kernel] chunk of 4 refs: sweep launches {sum(per_level.values()):.4f} ms, "
        f"zero-mean launches {zm_ms:.4f} ms; bound (taps {taps / 1e6:.1f} M at one load a lane a "
        f"cycle, {sms} SMs at {clock_hz / 1e6:.0f} MHz) {bound:.4f} ms")
    log(f"[mvs-kernel] _plane_sweep_batch through the kernels {paths['kernel_ms']:.3f} ms "
        f"({paths['kernel_launches']} kernel launches, {paths['kernel_ops']} device ops, busy "
        f"{paths['kernel_busy_ms']:.3f} ms); plain code {paths['plain_ms']:.3f} ms "
        f"({paths['plain_ops']} device ops, busy {paths['plain_busy_ms']:.3f} ms)")
    log(f"[mvs-kernel] registers, spill bytes: {sweep_regs}")
    if fails:
        raise AssertionError("MVS kernel check failed:\n  " + "\n  ".join(fails))
    return {"sweep_ms": per_level, "zero_mean_ms": zm_ms, "bound_ms": bound, **paths}


DIST_DIR = "chiprun_out/dist"
WINDOW = dict(window_cams=32, window_points=16384, freeze_cams=8, max_iterations=6,
              cg_iters=12)  # benchmarks/large_scene.py:188-195
DETECT_CHUNK = 8
N_QUERIES = 4096


def _ba_record(state, stats, wall_s):
    return {"poses": state.poses.cpu().numpy(), "points": state.points.cpu().numpy(),
            "stats": [float(v) for v in stats], "wall_s": wall_s}


def _timed(fn):
    """fn() twice (the first warms the allocator and the group); returns
    (the second call's result, its synchronized wall seconds)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _rank_job(rank, world, backend, port):
    """One rank of phase 15, spawned: joins the group on cuda:0 and runs
    the port's sharded paths on the maps phase 15 saved. With 2 gloo ranks:
    map BA, window BA, batched detection and matching, the map queries and
    MVS; with 1 NCCL rank: the map BA. Writes its results to DIST_DIR."""
    import datetime
    import pickle

    import torch.distributed as dist

    from sfm_mvs_tpu_torch.models import mvs
    from sfm_mvs_tpu_torch.ops import matching_cuda
    from sfm_mvs_tpu_torch.parallel import (consistency, distributed_ba, frontend,
                                            mesh as meshlib, sharded_map)
    from sfm_mvs_tpu_torch.utils import checkpoint

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    m = meshlib.make_mesh()
    out = {"rank": rank, "size": m.size, "backend": m.backend}
    # One CG step's collective: an all_reduce of (C, 6) floats, C = 64.
    x = torch.zeros(64 * 6, device=DEVICE)
    for _ in range(5):
        meshlib.all_reduce(x, m)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(100):
        meshlib.all_reduce(x, m)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t) * 10.0
    map57 = checkpoint.load_map(f"{DIST_DIR}/map57.npz", device=DEVICE)
    (st, stats), wall = _timed(lambda: distributed_ba.bundle_adjust_map_sharded(
        map57, m, max_iterations=8, cg_iters=15))
    consistency.assert_replicated(st.poses, m, "poses")
    consistency.assert_replicated(st.points, m, "points")
    out["map_ba"] = _ba_record(st, stats, wall)
    out["map_fingerprint"] = consistency.state_fingerprint(st)
    if backend == "nccl":
        with open(f"{DIST_DIR}/{backend}_{rank}.pkl", "wb") as fh:
            pickle.dump(out, fh)
        dist.destroy_process_group()
        return

    map250 = checkpoint.load_map(f"{DIST_DIR}/map250.npz", device=DEVICE)
    (st, stats), wall = _timed(lambda: distributed_ba.bundle_adjust_window_sharded(
        map250, m, **WINDOW))
    consistency.assert_replicated(st.poses, m, "window poses")
    out["window_ba"] = _ba_record(st, stats, wall)
    del map250, st

    # The front end: 57 frames in padded chunks of 8, then the 56 adjacent
    # pairs, each rank's 28 in one batched K1 launch.
    stack8 = torch.as_tensor(np.load(f"{DIST_DIR}/frames.npy"), device=DEVICE)
    frames = stack8.float() / 255.0
    cfg = main_config().frontend
    n = frames.shape[0]
    tracer_start()
    t = time.perf_counter()
    parts = []
    for s in range(0, n, DETECT_CHUNK):
        idx = [min(i, n - 1) for i in range(s, s + DETECT_CHUNK)]
        fb = frontend.detect_batch_sharded(frames[idx], cfg, m)
        parts.append([f[:min(DETECT_CHUNK, n - s)] for f in fb])
    feats = type(fb)(*[torch.cat(col) for col in zip(*parts)])
    pairs = torch.arange(n - 1, device=DEVICE)
    mt = frontend.match_pairs_sharded(feats, pairs, pairs + 1, m, cfg)
    torch.cuda.synchronize()
    out["frontend_s"] = time.perf_counter() - t
    out["launches"] = k1_counts()
    out["detect"] = (feats.xy.cpu().numpy(), feats.valid.cpu().numpy())
    # The same features through single launches, one pair at a time.
    diff = 0
    for i in range(n - 1):
        one = matching_cuda.knn_match_cuda(feats.desc[i], feats.desc[i + 1], feats.valid[i],
                                           feats.valid[i + 1], ratio=cfg.lowe_ratio)
        diff += int((one.idx1 != mt.idx1[i]).sum() + (one.valid != mt.valid[i]).sum())
    out["match"] = (diff, int(mt.valid.sum()), tuple(mt.idx1.shape))
    del frames, feats, mt

    # Map queries against phase 5's map, blocked over the ranks.
    blk = meshlib.shard_map_state(map57, m)
    P = map57.points.shape[0]
    tids = torch.arange(-3, P + 3, device=DEVICE, dtype=torch.int32)
    X, ok = sharded_map.lookup_points_sharded(blk.points, blk.point_valid, tids, m)
    inside = (tids >= 0) & (tids < P)
    safe = torch.clamp(tids, 0, P - 1).long()
    exp_X = torch.where(inside[:, None], map57.points[safe], torch.zeros(()).to(DEVICE))
    exp_ok = inside & map57.point_valid[safe]
    out["lookup"] = (int((X != exp_X).any(1).sum()), int((ok != exp_ok).sum()), int(ok.sum()))
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(15)
    W, H = SCENE["image_size"]
    uv_q = torch.rand((N_QUERIES, 2), generator=gen, device=DEVICE) * torch.tensor(
        [W, H], dtype=torch.float32, device=DEVICE)
    pose = map57.poses[int(map57.num_cams) // 2]
    d2_s, z_s = sharded_map.nearest_projected_sharded(blk.points, blk.point_valid, pose,
                                                      map57.K, uv_q, m)
    from sfm_mvs_tpu_torch.ops import projection

    uv_map, depth = projection.project_depth(map57.points, pose, map57.K)
    d2 = sharded_map.squared_distances(uv_q, uv_map)
    d2 = torch.where((map57.point_valid & (depth > 0))[None, :], d2,
                     torch.full_like(d2, float("inf")))
    dmin, j = d2.min(1)
    unique = (d2 == dmin[:, None]).sum(1) == 1
    rel = ((d2_s - dmin).abs() / dmin.abs().clamp_min(1e-30)).max()
    out["nearest"] = (float(rel), int((z_s != depth[j])[unique].sum()), int(unique.sum()))

    # MVS at phase 9's settings, each rank sweeping its slots of each batch.
    mvs_map = checkpoint.load_map(f"{DIST_DIR}/mvs_map.npz", device=DEVICE)
    k = int(mvs_map.cam_valid.sum())
    grays = [gray_of(stack8, i) for i in range(k)]
    bgrs = [bgr_of(stack8, i) for i in range(k)]
    tracer_start()
    t = time.perf_counter()
    pts, _, dms = mvs.densify_map(grays, mvs_map, **MVS_SETTINGS, images_bgr=bgrs,
                                  return_depth_maps=True, mesh=m)
    torch.cuda.synchronize()
    out["mvs_s"] = time.perf_counter() - t
    out["mvs_launches"] = (mvs_kernel_count(), -(-int(mvs_map.num_cams) // 4))
    out["mvs_points"] = len(pts)
    out["mvs_fingerprint"] = consistency.state_fingerprint(pts)
    if rank == 0:
        np.save(f"{DIST_DIR}/mvs_pts.npy", pts)
        np.savez(f"{DIST_DIR}/mvs_depth.npz", frames=np.array(sorted(dms)),
                 depth=np.stack([dms[r].depth.cpu().numpy() for r in sorted(dms)]),
                 valid=np.stack([dms[r].valid.cpu().numpy() for r in sorted(dms)]))
    with open(f"{DIST_DIR}/{backend}_{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


def _spawn_ranks(world, backend):
    """Runs _rank_job at `world` ranks (torch.multiprocessing, spawn); a
    rank that fails raises here. Returns each rank's results."""
    import pickle
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.spawn(_rank_job, args=(world, backend, port), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(f"{DIST_DIR}/{backend}_{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _rounded_rows(pts):
    """The set of points rounded to 3 decimals (tests/test_mvs.py's keys), as
    one sorted array of 12-byte rows."""
    r = np.ascontiguousarray(np.round(pts, 3).astype(np.float32))
    return np.unique(r.view(np.dtype((np.void, 12))).ravel())


def _ba_gates(name, rec, ref_state, ref_stats):
    """test_parallel.py:83-101's gates of one rank's BA against the
    single-process solve; returns the printout."""
    s0, s1 = rec["stats"][:2]
    dpose = float(np.abs(rec["poses"] - ref_state.poses.cpu().numpy()).max())
    dpts = float(np.abs(rec["points"] - ref_state.points.cpu().numpy()).max())
    i0, i1 = float(ref_stats.initial_cost), float(ref_stats.final_cost)
    ok = (abs(s0 - i0) <= 1e-5 * abs(i0) and abs(s1 - i1) <= 1e-2 * abs(i1) + 1e-6
          and dpose <= 1e-4 and dpts <= 1e-3)
    text = (f"{name}: cost {s0:.6f} -> {s1:.6f} px^2 (single process {i0:.6f} -> {i1:.6f}; "
            f"final bitwise equal: {s1 == i1}), max |d pose| {dpose:.3g}, max |d point| "
            f"{dpts:.3g}, {int(rec['stats'][2])} iterations in {rec['wall_s'] * 1e3:.1f} ms "
            f"({rec['wall_s'] * 1e3 / max(rec['stats'][2], 1):.2f} ms per LM iteration)")
    if not ok:
        raise AssertionError(f"sharded BA outside test_parallel.py's tolerances: {text}")
    return text


def phase_distributed(bench_map, mvs_state, s_align, mvs_pts, stitch_map, stack8, gt_depths):
    """Phase 15: the port's parallel/ paths at full width on the card, 2
    gloo ranks sharing cuda:0 and 1 NCCL rank, against single-process runs.
    Returns the ranks' batched K1 launches and MVS kernel launches."""
    from sfm_mvs_tpu_torch.models import ba
    from sfm_mvs_tpu_torch.ops import sift
    from sfm_mvs_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    try:
        t = time.perf_counter()
        checkpoint.save_map(f"{DIST_DIR}/map57.npz", bench_map)
        checkpoint.save_map(f"{DIST_DIR}/map250.npz", stitch_map)
        checkpoint.save_map(f"{DIST_DIR}/mvs_map.npz", mvs_state)
        np.save(f"{DIST_DIR}/frames.npy", stack8.cpu().numpy())
        save_s = time.perf_counter() - t

        # Single-process references, before the ranks share the card.
        (ref_map, ref_stats), map_s = _timed(
            lambda: ba.bundle_adjust_map(bench_map, max_iterations=8, cg_iters=15))
        (ref_win, ref_wstats), win_s = _timed(lambda: ba.bundle_adjust_window(stitch_map, **WINDOW))
        cfg = main_config().frontend
        n = stack8.shape[0]
        per_frame = [sift.detect_and_compute(gray_of(stack8, i), cfg) for i in range(n)]
        xy_ref = torch.stack([f.xy for f in per_frame]).cpu().numpy()
        valid_ref = torch.stack([f.valid for f in per_frame]).cpu().numpy()
        del per_frame
        torch.cuda.empty_cache()

        t = time.perf_counter()
        gloo = _spawn_ranks(2, "gloo")
        gloo_s = time.perf_counter() - t
        t = time.perf_counter()
        nccl = _spawn_ranks(1, "nccl")
        nccl_s = time.perf_counter() - t
        log(f"[dist] saved the maps and frames in {save_s:.1f} s; 2 gloo ranks on cuda:0 "
            f"{gloo_s:.1f} s, 1 NCCL rank {nccl_s:.1f} s (spawn, group and loads included); gloo "
            f"carried every collective's CUDA tensors itself (no host staging)")
        iters = max(int(ref_stats.iterations), 1)
        log(f"[dist] single process: map BA {map_s * 1e3:.1f} ms ({map_s * 1e3 / iters:.2f} ms "
            f"per LM iteration), window BA {win_s * 1e3:.1f} ms")
        for r in gloo + nccl:
            log("[dist] " + _ba_gates(f"map BA, {r['backend']} rank {r['rank']} of {r['size']}",
                                      r["map_ba"], ref_map, ref_stats)
                + f"; one all_reduce of 384 floats {r['allreduce_ms']:.3f} ms")
        for r in gloo:
            log("[dist] " + _ba_gates(f"window BA (32 cams, 16384 points), gloo rank {r['rank']}",
                                      r["window_ba"], ref_win, ref_wstats))
        log(f"[dist] state_fingerprint after BA: rank 0 {gloo[0]['map_fingerprint']}, rank 1 "
            f"{gloo[1]['map_fingerprint']}; poses and points replicated bitwise "
            f"(assert_replicated on each rank)")
        if gloo[0]["map_fingerprint"] != gloo[1]["map_fingerprint"]:
            raise AssertionError("the ranks' maps after BA differ (state_fingerprint)")

        for r in gloo:
            xy, valid = r["detect"]
            dxy = float(np.abs(np.where(valid_ref[..., None], xy - xy_ref, 0)).max())
            n_valid = int((valid != valid_ref).sum())
            single, batched, rows = r["launches"]
            diff, n_match, shape = r["match"]
            log(f"[dist] front end, rank {r['rank']}: detect_batch_sharded ({DETECT_CHUNK}-frame "
                f"chunks) max |d xy| {dxy:.3g}, valid mismatches {n_valid}; match_pairs_sharded "
                f"{shape}: {n_match} matches, {diff} idx1/valid differences from single launches; "
                f"K1 batched launches {batched} over {rows} pairs, single {single}; "
                f"{r['frontend_s']:.2f} s")
            if not dxy <= 1e-4 or n_valid or diff or (single, batched, rows) != (0, 1, (n - 1) // 2):
                raise AssertionError(f"front end at rank {r['rank']} failed its gates")
            miss_x, miss_ok, n_ok = r["lookup"]
            rel, zdiff, n_unique = r["nearest"]
            log(f"[dist] map queries, rank {r['rank']}: lookup of "
                f"{bench_map.points.shape[0] + 6} ids ({n_ok} valid): {miss_x} X and {miss_ok} ok "
                f"mismatches; nearest of {N_QUERIES} pixels: max rel d2 {rel:.3g}, depth "
                f"mismatches {zdiff} where the argmin is unique ({n_unique})")
            if miss_x or miss_ok or not rel <= 1e-5 or zdiff:
                raise AssertionError(f"map queries at rank {r['rank']} failed their gates")

        pts = np.load(f"{DIST_DIR}/mvs_pts.npy")
        dz = np.load(f"{DIST_DIR}/mvs_depth.npz")
        rms, med, under, cov = depth_gates(zip(dz["frames"], dz["depth"], dz["valid"]),
                                           gt_depths, s_align)
        a, b = _rounded_rows(pts), _rounded_rows(mvs_pts)
        overlap = len(np.intersect1d(a, b, assume_unique=True)) / max(len(b), 1)
        n1 = len(mvs_pts)
        same = gloo[0]["mvs_fingerprint"] == gloo[1]["mvs_fingerprint"]
        log(f"[dist] MVS, 2 ranks: {len(pts)} points (unsharded {n1}), rounded-point overlap "
            f"{overlap:.5f}, the same cloud on both ranks: {same}; depth rel-RMS {rms:.5f} median "
            f"{med:.5f} under 1% {under:.4f} coverage {cov:.4f}; {gloo[0]['mvs_s']:.1f} / "
            f"{gloo[1]['mvs_s']:.1f} s")
        log("[dist] times are of 2 ranks sharing one card over gloo: not a scaling figure")
        for r in gloo:
            n_mvs, chunks = r["mvs_launches"]
            log(f"[dist] MVS, rank {r['rank']}: {n_mvs} MVS kernel launches over {chunks} chunks")
            if n_mvs != MVS_LAUNCHES_A_CHUNK * chunks:
                raise AssertionError(f"rank {r['rank']}: {n_mvs} MVS kernel launches in "
                                     f"densify_map(mesh=), expected {MVS_LAUNCHES_A_CHUNK} x "
                                     f"{chunks} chunks")
        if abs(len(pts) - n1) > max(5, n1 // 100) or not overlap > 0.98 or not same:
            raise AssertionError("sharded MVS outside tests/test_mvs.py's bounds")
        if not med < 0.01 or not rms < 0.03 or not cov > 0.65:
            raise AssertionError(f"sharded MVS depth median {med} / rel-RMS {rms} / coverage {cov}")
    finally:
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    log(f"[dist] phase 15 {time.perf_counter() - t_phase:.1f} s")
    return sum(r["launches"][1] for r in gloo), sum(r["mvs_launches"][0] for r in gloo)


class Renders:
    """The scenes of phases 11 and 14, rendered on the host by one spawned
    worker process while the earlier phases drive the card."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing

        from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence

        self._pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))
        self._jobs = {
            "distorted": self._pool.submit(render_staircase_sequence, **SCENE, dist=DIST),
            "large": self._pool.submit(render_staircase_sequence, **LARGE),
        }

    def get(self, name):
        """(the render's result, seconds waited for it)."""
        t0 = time.time()
        out = self._jobs[name].result()
        return out, time.time() - t0

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)


def main(argv) -> int:
    t_start = time.time()
    smi = phase_device()
    import sfm_mvs_tpu_torch  # noqa: F401  (sets full-fp32 matmul flags)

    os.makedirs("chiprun_out", exist_ok=True)
    if "--ba-graph" in argv:
        phase_ba_graph()
        return 0
    build_s, registers, spills, mvs_regs = phase_build()
    if "--mvs" in argv:
        from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence

        imgs, Rt_gt, K, gt_depths = render_staircase_sequence(**SCENE, return_depth=True)
        phase_mvs_kernel(mvs_regs, _stair_chunk(imgs, Rt_gt, K, gt_depths))
        return 0
    renders = Renders()
    try:
        return run_phases(argv, smi, t_start, build_s, registers, spills, mvs_regs, renders)
    finally:
        renders.close()


def run_phases(argv, smi, t_start, build_s, registers, spills, mvs_regs, renders) -> int:
    from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence

    t0 = time.time()
    imgs, Rt_gt, K, gt_depths = render_staircase_sequence(**SCENE, return_depth=True)
    log(f"[scene] rendered {len(imgs)} frames {SCENE['image_size']} in {time.time() - t0:.1f}s")
    cfg = main_config()
    k1 = phase_k1(sift_pair(imgs, cfg))
    k1_batch = phase_k1_batch(sift_pairs(imgs, cfg, 8), cfg.frontend.lowe_ratio)
    mvs_kernel = phase_mvs_kernel(mvs_regs, _stair_chunk(imgs, Rt_gt, K, gt_depths))
    phase_ba_graph()
    launches, ate_ba_off = phase_main(imgs, Rt_gt, cfg)
    n, bench_map = phase_bench(imgs, Rt_gt, cfg, ate_ba_off)
    launches += n
    launches += phase_driver(imgs, Rt_gt, cfg, ate_ba_off)
    stack8 = stage_u8(imgs)
    write_frames(stack8)
    launches += phase_cli(Rt_gt)
    launches += phase_loop_cli(Rt_gt)
    launches += phase_resume()
    mvs_map, mvs_pts, s_align, mvs_launches = phase_mvs(stack8, bench_map, Rt_gt, gt_depths)
    launches += phase_intrinsics(cfg, renders)
    launches += phase_global(cfg)
    launches += phase_klt(imgs, Rt_gt, cfg)
    n, batch_launches, stitch_map = phase_stitch(renders)
    launches += n
    n, n_mvs = phase_distributed(bench_map, mvs_map, s_align, mvs_pts, stitch_map, stack8,
                                 gt_depths)
    batch_launches += n
    mvs_launches += n_mvs
    del stitch_map, mvs_pts
    log(f"[total] {time.time() - t_start:.1f} s, kernel build included")
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "knn2", "route": "cuda", "source": "sfm_mvs_tpu_torch/csrc/knn2.cu",
        "replaces": "sfm_mvs_tpu/ops/matching_pallas.py:55", "launches": launches,
        **k1, "registers": registers, "spills": spills,
    }, {
        "name": "knn2_batch", "route": "cuda", "source": "sfm_mvs_tpu_torch/csrc/knn2.cu",
        "replaces": "sfm_mvs_tpu/ops/matching_pallas.py:55", "launches": batch_launches,
        **k1_batch, "registers": registers, "spills": spills,
    }, {
        "name": "mvs_sweep", "route": "cuda", "source": "sfm_mvs_tpu_torch/csrc/mvs_sweep.cu",
        "replaces": None, "launches": mvs_launches,
        "registers": {k: v[0] for k, v in mvs_regs.items()},
        "spills": {k: v[1] for k, v in mvs_regs.items()}, **mvs_kernel,
    }], "build_s": build_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
