"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the check
    python3 chip_smoke.py --profile    # the check, then where a frame's time goes

Phases, each printing one line (any failure exits non-zero):

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles the port's CUDA sources (csrc/*.cu) with nvcc.
3. K1: the 2-NN matcher kernel against its plain PyTorch version on the
   card, on five cases, then both timed at 4096 x 4096 x 128.
4. main path: ``IncrementalSfM(cfg, device="cuda").run(images)`` on the
   57-frame 968x648 staircase scene at bench.py's frontend settings; checks
   registration, ATE and reprojection error against ground truth, and that
   the run went through the kernel (its launch counter).
5. the last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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
    from sfm_mvs_tpu_torch.ops import matching_cuda

    t0 = time.time()
    path = matching_cuda.build()
    secs = time.time() - t0
    ptxas = [ln.strip() for ln in matching_cuda.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"[build] csrc/knn2.cu -> {path.name} in {secs:.1f}s; "
        + " | ".join(ptxas))
    return secs


def _descs(rng, n, d=128):
    x = rng.random((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _k1_cases(real_pair):
    """(name, desc0, desc1, valid0, valid1, ratio) as numpy arrays."""
    rng = np.random.default_rng(0)
    cases = []
    d0 = _descs(rng, 300)
    d1 = d0[rng.permutation(300)] + 0.01 * rng.standard_normal((300, 128)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    cases.append(("300x300", d0, d1, np.ones(300, bool), np.ones(300, bool), 0.7))
    d0 = _descs(rng, 100)
    d1 = np.vstack([_descs(rng, 500), d0[:100]]).astype(np.float32)
    cases.append(("100x600", d0, d1, np.ones(100, bool), np.ones(600, bool), 0.8))
    d0 = _descs(rng, 64)
    d1 = np.vstack([d0[:32], d0[:32]]).astype(np.float32)
    cases.append(("invalid-masks", d0, d1, np.arange(64) < 40, np.arange(64) < 32, 0.7))
    d0 = _descs(rng, 4095)
    d1 = np.vstack([d0[rng.permutation(4095)][:2048]
                    + 0.02 * rng.standard_normal((2048, 128)).astype(np.float32),
                    _descs(rng, 2049)]).astype(np.float32)
    v1 = rng.random(4097) > 0.05
    cases.append(("4095x4097", d0, d1, rng.random(4095) > 0.05, v1, 0.75))
    cases.append(real_pair)
    return cases


def _time_ms(fn, reps=25):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_k1(real_pair):
    from sfm_mvs_tpu_torch.ops import matching, matching_cuda

    dev = DEVICE
    worst = 0.0
    for name, d0, d1, v0, v1, ratio in _k1_cases(real_pair):
        t = [torch.as_tensor(a, device=dev) for a in (d0, d1, v0, v1)]
        kd1, kj1, kd2 = matching_cuda.knn2_raw(t[0], t[1], t[3])
        pd1, pj1, pd2 = matching.top2(matching.distance_matrix(t[0], t[1], t[3]))
        km = matching_cuda.knn_match_cuda(*t, ratio=ratio)
        pm = matching.knn_match(*t, ratio=ratio)
        torch.cuda.synchronize()
        # Compared on valid query rows: an invalid SIFT slot may carry a
        # NaN descriptor, whose row neither version ever reports as a match.
        q = t[2]
        err = max(float((kd1 - pd1)[q].abs().max()), float((kd2 - pd2)[q].abs().max()))
        worst = max(worst, err)
        decided = (pd2 - pd1) > MARGIN
        r2d2 = (ratio * ratio) * pd2
        clear = (pd1 - r2d2).abs() > MARGIN
        n_idx = int((q & decided & (kj1 != pj1.to(torch.int32))).sum())
        n_val = int((clear & (km.valid != pm.valid)).sum())
        n_inside = int((q & (~decided | ~clear)).sum())
        log(f"[k1] {name}: max|dd|={err:.3g} over {int(q.sum())} valid queries, "
            f"idx_mismatch={n_idx} valid_mismatch={n_val} inside_margin={n_inside} "
            f"matches={int(pm.valid.sum())}/{len(v0)}")
        if not err <= DIST_ATOL or n_idx or n_val or bool((km.valid & ~q).any()):
            raise AssertionError(f"K1 disagrees with its plain version on {name}")

    name, d0, d1, v0, v1, ratio = real_pair
    t = [torch.as_tensor(a, device=dev) for a in (d0, d1, v0, v1)]
    ms_kernel = _time_ms(lambda: matching_cuda.knn_match_cuda(*t, ratio=ratio))
    ms_plain = _time_ms(lambda: matching.knn_match(*t, ratio=ratio))
    log(f"[k1] time at {d0.shape[0]}x{d1.shape[0]}x{d0.shape[1]}: kernel "
        f"{ms_kernel:.4f} ms, plain {ms_plain:.4f} ms (CUDA events, median of 25)")
    return worst, ms_kernel, ms_plain


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


def phase_main(imgs, Rt_gt, cfg):
    from sfm_mvs_tpu_torch.models import map_store
    from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM
    from sfm_mvs_tpu_torch.ops import matching_cuda, sift
    from sfm_mvs_tpu_torch.utils import evaluate

    sfm = IncrementalSfM(cfg, device=DEVICE)
    matching_cuda.reset_launches()
    t0 = time.perf_counter()
    state = sfm.run(imgs)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = matching_cuda.launches

    cam_valid = state.cam_valid.cpu().numpy()
    poses = state.poses.cpu().numpy()[cam_valid]
    n_cams = int(cam_valid.sum())
    ate = evaluate.ate_rmse(poses, Rt_gt[: len(poses)]) if n_cams >= 3 else float("inf")
    rot = float(evaluate.rotation_errors_deg(poses, Rt_gt[: len(poses)]).max())
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
    return launches


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


def phase_profile(imgs, cfg, n_frames=10):
    """Where the time goes (``--profile`` only): the synchronized wall time
    of each stage of a frame over the first ``n_frames`` frames, then
    torch.profiler over two warm registrations for the device's busy share
    and its busiest operations. Full tables go to chiprun_out/profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    from sfm_mvs_tpu_torch.models import incremental, map_store
    from sfm_mvs_tpu_torch.ops import matching, pnp, ransac, sift, triangulation

    stages = {}
    originals = []

    def timed(mod, name, key):
        fn = getattr(mod, name)
        originals.append((mod, name, fn))

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages.setdefault(key, []).append(time.perf_counter() - t)
            return out

        setattr(mod, name, wrapper)

    timed(sift, "detect_and_compute", "detect")
    timed(matching, "match_with_config", "match")
    timed(ransac, "ransac_pnp", "ransac_pnp")
    timed(pnp, "refine_pose_gauss_newton", "pnp_polish (2 per frame)")
    timed(triangulation, "triangulate_euclidean", "triangulate")
    timed(map_store, "append_points", "append_points")
    timed(map_store, "append_observations", "append_observations (4 per frame)")
    timed(incremental, "register_frame", "register_frame")
    try:
        sfm = incremental.IncrementalSfM(cfg, device=DEVICE)
        sfm.run(imgs[:n_frames])
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    frame_ms = [s["wall_s"] * 1e3 for s in sfm.stats]
    lines = [f"frames 1..{n_frames - 1} wall ms: " + ", ".join(f"{t:.1f}" for t in frame_ms)]
    for key, secs in stages.items():
        warm = secs[2:] if len(secs) > 4 else secs
        lines.append(f"{key:36s} n={len(secs):3d} median {statistics.median(warm) * 1e3:8.2f} ms")

    dev = DEVICE
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    feats = [sift.detect_and_compute(torch.as_tensor(imgs[i], device=dev), cfg.frontend)
             for i in range(5)]
    bgr = [torch.as_tensor(np.repeat((g * 255.0)[..., None], 3, -1).astype(np.float32),
                           device=dev) for g in imgs[:5]]
    K = torch.as_tensor(cfg.intrinsic_matrix(), device=dev)
    ps, _ = incremental.init_from_bootstrap(gen, feats[0], feats[1], bgr[1], K, cfg)
    ps, _ = incremental.register_frame(gen, ps, feats[2], bgr[2], cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in (3, 4):
            ps, _ = incremental.register_frame(gen, ps, feats[i], bgr[i], cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy, n_kernels = _device_busy_ms(prof)
    summary = (f"[profile] 2 warm registrations: wall {wall:.1f} ms, device busy "
               f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}, {n_kernels} device ops")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=30,
                                      max_name_column_width=70)
    with open("chiprun_out/profile.txt", "w") as fh:
        fh.write("\n".join(lines + [summary, table]) + "\n")
    for ln in lines:
        log(f"[profile] {ln}")
    log(summary)


def main(argv) -> int:
    smi = phase_device()
    import os

    import sfm_mvs_tpu_torch  # noqa: F401  (sets full-fp32 matmul flags)
    from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence

    os.makedirs("chiprun_out", exist_ok=True)
    build_s = phase_build()
    t0 = time.time()
    imgs, Rt_gt, _ = render_staircase_sequence(**SCENE)
    log(f"[scene] rendered {len(imgs)} frames {SCENE['image_size']} in {time.time() - t0:.1f}s")
    cfg = main_config()
    worst, ms_k, ms_p = phase_k1(sift_pair(imgs, cfg))
    launches = phase_main(imgs, Rt_gt, cfg)
    if "--profile" in argv:
        phase_profile(imgs, cfg)
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "knn2", "route": "cuda", "source": "sfm_mvs_tpu_torch/csrc/knn2.cu",
        "replaces": "sfm_mvs_tpu/ops/matching_pallas.py:55", "launches": launches,
        "max_abs_err": worst, "ms": ms_k, "plain_ms": ms_p,
    }], "build_s": build_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
