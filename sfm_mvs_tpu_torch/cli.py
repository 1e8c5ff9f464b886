"""Command-line interface of the PyTorch / CUDA port.

The JAX package's ``sfm_mvs_tpu/cli.py`` with the same flags, defaults and
outputs, plus ``--device`` (default ``cuda``; the counterpart of
``JAX_PLATFORMS``). ``--device cuda`` without a usable GPU raises; nothing
falls back to the CPU.

    python -m sfm_mvs_tpu_torch --image-dir /data/gustav \\
        --fx 2393.95 --fy 2398.12 --cx 932.38 --cy 628.26 \\
        --downscale 2 --ba --out Point_Cloud

Outputs: sparse.ply (reference cleaning semantics), dense.ply with
--densify, pose.csv, cameras.ply frusta, reproj_error.png, sfm.gif,
metrics.jsonl; checkpoints every K frames with --checkpoint-every.
reproj_error.png needs matplotlib and sfm.gif matplotlib and PIL: where
one is missing, that file is skipped with a warning on stderr.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sfm_mvs_tpu_torch",
        description="Incremental Structure-from-Motion (PyTorch / CUDA port)")
    p.add_argument("--image-dir", required=True, help="directory of ordered .jpg/.png")
    p.add_argument("--out", default="Point_Cloud", help="output directory")
    p.add_argument("--device", default="cuda",
                   help="torch device every tensor lives on (cuda, cuda:N or cpu)")
    p.add_argument("--fx", type=float, default=2393.952166119461)
    p.add_argument("--fy", type=float, default=2398.118540286656)
    p.add_argument("--cx", type=float, default=932.3821770809047)
    p.add_argument("--cy", type=float, default=628.2649953288065)
    p.add_argument("--downscale", type=int, default=2, help="power-of-two (sfm.py:19)")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--max-features", type=int, default=4096)
    p.add_argument("--lowe-ratio", type=float, default=0.70)
    p.add_argument("--contrast-threshold", type=float, default=0.012)
    p.add_argument("--no-upsample", action="store_true", help="skip 2x input doubling")
    p.add_argument("--grad-sampling", choices=["nearest_polar", "bilinear"],
                   default="nearest_polar",
                   help="orientation/descriptor gradient sampling (nearest_polar: "
                        "one read of the bf16 polar maps, OpenCV's per-pixel reads; "
                        "bilinear: interpolated (dx, dy))")
    p.add_argument("--essential-threshold", type=float, default=2.0)
    p.add_argument("--essential-solver", choices=["8pt", "5pt"], default="8pt",
                   help="minimal E solver: 8-point or Nister 5-point "
                        "(the reference's OpenCV solver; planar-safe)")
    p.add_argument("--pnp-threshold", type=float, default=4.0)
    p.add_argument("--ba", action="store_true", help="enable bundle adjustment")
    p.add_argument("--ba-cadence", type=int, default=1, help="BA every K frames")
    p.add_argument("--ba-iterations", type=int, default=10)
    p.add_argument("--max-cameras", type=int, default=64)
    p.add_argument("--max-points", type=int, default=65536)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true", help="resume from last checkpoint")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bootstrap", choices=["seq", "auto"], default="seq",
                   help="bootstrap pair: seq = frames (0,1) like the reference "
                        "(sfm.py:300-302); auto = strongest sufficient-parallax "
                        "view-graph pair")
    p.add_argument("--loop-close", type=int, default=0,
                   help="inject re-observations from the top-K strong non-adjacent "
                        "pairs before the final BA")
    p.add_argument("--pipeline", choices=["incremental", "global"], default="incremental",
                   help="incremental = sfm.py-style PnP registration; global = "
                        "test.py-style homography-chained tracks + global BA")
    p.add_argument("--ba-local-window", type=int, default=0,
                   help="local BA: optimize only the last K cameras")
    p.add_argument("--ba-refine-intrinsics", action="store_true",
                   help="refine shared [focal_scale, k1, k2] in the final global BA "
                        "(notebook prototype's camera model)")
    p.add_argument("--ba-refine-intrinsics-per-camera", action="store_true",
                   help="refine (f, k1, k2) per camera in the final global BA (the "
                        "notebook's full 9-param camera); recovered blocks are "
                        "reported in the finalize info")
    p.add_argument("--batch-detect", type=int, default=0,
                   help="pre-detect features in chunks of this size")
    p.add_argument("--no-pallas-matcher", action="store_true",
                   help="match with the plain PyTorch 2-NN instead of the CUDA kernel")
    p.add_argument("--no-merge", action="store_true",
                   help="disable re-observation track merging")
    p.add_argument("--finalize", action="store_true",
                   help="final polish: cull outlier observations + global BA")
    p.add_argument("--sweep", action="store_true",
                   help="final densification sweep: re-match every adjacent pair "
                        "from the solved trajectory and triangulate all good matches "
                        "(reference cloud density, sfm.py:387-395)")
    p.add_argument("--sweep-features", type=int, default=0,
                   help="sweep-time detection budget (0 = run budget)")
    p.add_argument("--sweep-contrast", type=float, default=0.0,
                   help="sweep-time contrast threshold (0 = run threshold)")
    p.add_argument("--sweep-grow", type=int, default=65536,
                   help="map point capacity for the sweep")
    p.add_argument("--sweep-reproj", type=float, default=1.5,
                   help="both-view reprojection gate for swept points (px)")
    p.add_argument("--sweep-dedup", type=float, default=1.0,
                   help="projected-pixel dedup radius against the map (px)")
    p.add_argument("--densify", action="store_true",
                   help="plane-sweep MVS depth + fusion -> dense.ply (the reference's "
                        "declared-but-unimplemented mode, sfm.py:298)")
    p.add_argument("--mvs-depths", type=int, default=64)
    p.add_argument("--mvs-stride", type=int, default=2)
    p.add_argument("--no-gif", action="store_true",
                   help="skip the orbiting turntable render (sfm.gif)")
    return p


def config_from_args(args):
    from sfm_mvs_tpu_torch.utils.config import (
        BaConfig, FrontendConfig, MapConfig, RansacConfig, SfmConfig, SweepConfig,
    )

    return SfmConfig(
        fx=args.fx, fy=args.fy, cx=args.cx, cy=args.cy, downscale=args.downscale,
        image_dir=args.image_dir, output_dir=args.out, max_images=args.max_images,
        bootstrap=args.bootstrap, loop_close_pairs=args.loop_close,
        frontend=FrontendConfig(
            max_features=args.max_features, lowe_ratio=args.lowe_ratio,
            contrast_threshold=args.contrast_threshold,
            upsample_input=not args.no_upsample,
            use_pallas_matcher=not args.no_pallas_matcher,
            grad_sampling=args.grad_sampling,
        ),
        ransac=RansacConfig(
            essential_threshold_px=args.essential_threshold,
            essential_solver=args.essential_solver,
            pnp_threshold_px=args.pnp_threshold, seed=args.seed,
            merge_reobservations=not args.no_merge,
        ),
        ba=BaConfig(
            enabled=args.ba, cadence=args.ba_cadence, max_iterations=args.ba_iterations,
            local_window=args.ba_local_window,
            refine_intrinsics=args.ba_refine_intrinsics,
            refine_intrinsics_per_camera=args.ba_refine_intrinsics_per_camera,
        ),
        map=MapConfig(max_cameras=args.max_cameras, max_points=args.max_points),
        sweep=SweepConfig(
            enabled=args.sweep, max_features=args.sweep_features,
            contrast_threshold=args.sweep_contrast, grow_points=args.sweep_grow,
            reproj_px=args.sweep_reproj, dedup_px=args.sweep_dedup,
        ),
    )


def _device(name: str):
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available on this machine "
                           "(use --device cpu to run on the CPU)")
    return dev


def _optional_artifact(path: str, fn, *args, **kwargs) -> None:
    """Write an artifact that needs matplotlib/PIL; where the package is not
    installed, skip the file with a warning."""
    try:
        fn(path, *args, **kwargs)
    except ImportError as e:
        print(f"warning: {os.path.basename(path)} skipped: {e.name} not installed",
              file=sys.stderr)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    dev = _device(args.device)

    from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM
    from sfm_mvs_tpu_torch.native import ImageLoader
    from sfm_mvs_tpu_torch.utils import checkpoint as ckpt
    from sfm_mvs_tpu_torch.utils import io, metrics, viz

    paths = io.list_images(args.image_dir)
    if args.max_images:
        paths = paths[: args.max_images]
    if len(paths) < 2:
        print(f"need >= 2 images in {args.image_dir}", file=sys.stderr)
        return 2

    print(f"loading {len(paths)} images (downscale={args.downscale}) ...")
    loader = ImageLoader(paths, downscale=args.downscale, load_color=True)
    grays, bgrs = [], []
    for i in range(len(paths)):
        g, b = loader.get(i)
        grays.append(g)
        bgrs.append(b)
    loader.close()

    os.makedirs(args.out, exist_ok=True)
    logger = metrics.MetricsLogger(os.path.join(args.out, "metrics.jsonl"))
    ckpt_dir = os.path.join(args.out, "checkpoints")
    sfm = IncrementalSfM(cfg, device=dev, metrics=logger,
                         checkpoint_dir=ckpt_dir if args.checkpoint_every else None,
                         checkpoint_every=args.checkpoint_every)

    resume_state, resume_frame = None, 0
    if args.resume:
        latest = ckpt.latest_checkpoint(ckpt_dir)
        if latest:
            resume_state, resume_frame = ckpt.load_pipeline(latest, device=dev)
            print(f"resuming from {latest} (frame {resume_frame})")

    incremental_only = (args.sweep or args.loop_close or args.ba_refine_intrinsics
                        or args.ba_refine_intrinsics_per_camera)
    if args.pipeline == "global":
        from sfm_mvs_tpu_torch.models.tracks import GlobalSfM

        gsfm = GlobalSfM(cfg, device=dev)
        state = gsfm.run(grays, seed=args.seed, run_ba=True)
        state = gsfm.final_sweep(grays)
        sfm.stats = [{**st, "reproj_error": st.get("reproj_error", 0.0)}
                     for st in gsfm.stats if "frame" in st]
        if incremental_only:
            print("warning: --sweep/--loop-close/--ba-refine-intrinsics are "
                  "incremental-pipeline features and are ignored with "
                  "--pipeline global (use --finalize for cull + global BA)", file=sys.stderr)
    else:
        state = sfm.run(grays, bgrs, seed=args.seed, resume_state=resume_state,
                        resume_frame=resume_frame, batch_detect=args.batch_detect)
    if args.pipeline == "incremental" and (args.finalize or incremental_only):
        state = sfm.finalize(ba_iterations=args.ba_iterations)
        print(f"finalize: {sfm.finalize_info}")
    elif args.finalize:
        from sfm_mvs_tpu_torch.models.refine import finalize_map

        state, info = finalize_map(state, max_iterations=args.ba_iterations)
        print(f"finalize: {info}")
    n = io.map_to_ply(os.path.join(args.out, "sparse.ply"), state,
                      scale=cfg.ply_scale, outlier_offset=cfg.ply_outlier_offset)
    if args.densify:
        from sfm_mvs_tpu_torch.models import mvs

        dpts, dcols = mvs.densify_map(grays, state, num_depths=args.mvs_depths,
                                      stride=args.mvs_stride, images_bgr=bgrs)
        nd = io.to_ply(os.path.join(args.out, "dense.ply"), dpts, dcols,
                       scale=cfg.ply_scale, outlier_offset=cfg.ply_outlier_offset)
        print(f"dense cloud: {nd} points -> dense.ply")
    io.map_pose_csv(os.path.join(args.out, "pose.csv"), state)
    # The map moves to the host once for the remaining artifacts.
    cam_valid = state.cam_valid.cpu().numpy()
    poses = state.poses.cpu().numpy()[cam_valid]
    viz.save_camera_frusta_ply(os.path.join(args.out, "cameras.ply"), poses)
    errs = [s.get("reproj_error", 0.0) for s in sfm.stats]
    _optional_artifact(os.path.join(args.out, "reproj_error.png"), viz.save_error_plot, errs)
    if not args.no_gif:
        pv = state.point_valid.cpu().numpy()
        _optional_artifact(os.path.join(args.out, "sfm.gif"), viz.save_turntable_gif,
                           state.points.cpu().numpy()[pv], state.colors.cpu().numpy()[pv],
                           poses, n_frames=24)
    print(f"done: {len(poses)} cameras, {n} cloud points -> {args.out}/")
    print(logger.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
