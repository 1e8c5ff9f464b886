#!/usr/bin/env python
"""Reference records the PyTorch port is held to, run on the CPU.

    python scripts/torch_port_records.py c8 [--seeds 0,1,2,3] [--pkgs P,Q] [--out DIR]
    python scripts/torch_port_records.py klt [--out DIR]
    python scripts/torch_port_records.py lk

``c8``: both CLIs (``python -m sfm_mvs_tpu`` and ``python -m
sfm_mvs_tpu_torch --device cpu``) with ``--pipeline global --finalize`` on
the 11-view 968x648 plane written as 8-bit PNGs (chip_smoke.py phase 12's
scene and flags), once per seed; one JSON line per run: ATE against ground
truth and the CLI's printed finalize costs.

``klt``: the JAX package's ``KltSfM(redetect_every=5)`` on chip_smoke.py
phase 4's 57-frame 968x648 staircase at its ``main_config()``; one JSON
line, the record phase 13 is gated against (``KLT_RECORD`` there).

``lk``: the port's ``track_points`` from frame 1 to frame 2 of that scene
(frame 1's SIFT keypoints) at several ``min_eig`` / ``max_error`` gates:
valid tracks, detections and the median patch error.

Each subcommand imports one package only; run from the repository root
with ``JAX_PLATFORMS=cpu``. Outputs go under ``--out`` (default
``chiprun_out/records``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# chip_smoke.py's SCENE, main_config() and PLANE.
SCENE = dict(num_cameras=57, image_size=(968, 648), focal=1200.0, radius=9.0,
             arc_degrees=50.0, num_strips=10, depth_spread=2.0)
PLANE = dict(num_cameras=11, image_size=(968, 648), focal=1200.0, radius=6.0, arc_degrees=30.0)
PLANE_FLAGS = ["--fx", "1200", "--fy", "1200", "--cx", "484", "--cy", "324", "--downscale", "1",
               "--max-features", "4096", "--lowe-ratio", "0.75", "--contrast-threshold", "0.012",
               "--max-cameras", "64", "--max-points", "16384", "--pipeline", "global",
               "--finalize", "--no-gif"]


def _main_config(config):
    W, H = SCENE["image_size"]
    f = SCENE["focal"]
    return config.SfmConfig(
        fx=f, fy=f, cx=W / 2.0, cy=H / 2.0, downscale=1,
        frontend=config.FrontendConfig(max_features=4096, num_octaves=4, upsample_input=True,
                                       contrast_threshold=0.012, lowe_ratio=0.75),
        ransac=config.RansacConfig(essential_iters=2048, pnp_iters=1024),
        map=config.MapConfig(max_cameras=64, max_points=16384))


def c8(seeds, pkgs, out):
    from PIL import Image

    from sfm_mvs_tpu_torch.utils import evaluate, io
    from sfm_mvs_tpu_torch.utils.synthetic import render_plane_sequence

    frames = os.path.join(out, "plane_frames")
    os.makedirs(frames, exist_ok=True)
    imgs, Rt, _ = render_plane_sequence(**PLANE)
    for i, im in enumerate(imgs):
        Image.fromarray((np.clip(im, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(frames, f"frame_{i:03d}.png"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for seed in seeds:
        for pkg in pkgs:
            dst = os.path.join(out, f"{pkg}_{seed}")
            args = [sys.executable, "-m", pkg, "--image-dir", frames, "--out", dst,
                    *PLANE_FLAGS, "--seed", str(seed)]
            if pkg == "sfm_mvs_tpu_torch":
                args += ["--device", "cpu"]
            t0 = time.time()
            r = subprocess.run(args, cwd=REPO, env=env, capture_output=True, text=True)
            rec = {"pkg": pkg, "seed": seed, "rc": r.returncode, "s": time.time() - t0}
            if r.returncode == 0:
                K, Ps = io.load_pose_csv(os.path.join(dst, "pose.csv"))
                poses = np.asarray(io.poses_from_projections(K, Ps))
                rec["ate"] = float(evaluate.ate_rmse(poses, Rt[:len(poses)]))
                fin = [ln for ln in r.stdout.splitlines() if ln.startswith("finalize: ")]
                rec["finalize"] = fin[-1][len("finalize: "):] if fin else None
            else:
                rec["stderr"] = r.stderr[-2000:]
            print(json.dumps(rec), flush=True)


def klt():
    from sfm_mvs_tpu.models.klt import KltSfM
    from sfm_mvs_tpu.utils import config, evaluate
    from sfm_mvs_tpu.utils.synthetic import render_staircase_sequence

    imgs, Rt, _ = render_staircase_sequence(**SCENE)
    t0 = time.time()
    k = KltSfM(_main_config(config), redetect_every=5)
    state = k.run(imgs)
    wall = time.time() - t0
    cv = np.asarray(state.cam_valid)
    poses = np.asarray(state.poses)[cv]
    n = len(poses)
    st = k.stats
    print(json.dumps({
        "cameras": n, "points": int(state.num_points),
        "ate": float(evaluate.ate_rmse(poses, Rt[:n])),
        "rot": float(evaluate.rotation_errors_deg(poses, Rt[:n]).max()),
        "tracked_min": min(s["tracked"] for s in st),
        "tracked_max": max(s["tracked"] for s in st),
        "pnp_min": min(s["pnp_inliers"] for s in st),
        "pnp_max": max(s["pnp_inliers"] for s in st),
        "reproj_max": max(s["reproj_error"] for s in st),
        "wall_s": wall}), flush=True)


def lk():
    import torch

    from sfm_mvs_tpu_torch.ops import optical_flow, sift
    from sfm_mvs_tpu_torch.utils import config
    from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence

    imgs, _, _ = render_staircase_sequence(**SCENE)
    g1, g2 = torch.as_tensor(imgs[1]), torch.as_tensor(imgs[2])
    f = sift.detect_and_compute(g1, _main_config(config).frontend)
    for min_eig, max_error in ((1e-4, 0.15), (1e-5, 0.15), (1e-4, 1.0), (0.0, 10.0)):
        r = optical_flow.track_points(g1, g2, f.xy, f.valid, min_eig=min_eig,
                                      max_error=max_error)
        print(json.dumps({"min_eig": min_eig, "max_error": max_error,
                          "valid": int(r.valid.sum()), "detected": int(f.valid.sum()),
                          "median_error": float(r.error[f.valid].median())}), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=("c8", "klt", "lk"))
    p.add_argument("--seeds", default="0,1,2,3")
    p.add_argument("--pkgs", default="sfm_mvs_tpu,sfm_mvs_tpu_torch")
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "records"))
    a = p.parse_args()
    if a.what == "c8":
        c8([int(s) for s in a.seeds.split(",")], a.pkgs.split(","), a.out)
    elif a.what == "klt":
        klt()
    else:
        lk()
    return 0


if __name__ == "__main__":
    sys.exit(main())
