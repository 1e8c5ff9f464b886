"""The port runs where JAX is absent (the GPU machine has no jax).

In a fresh interpreter with ``jax`` and ``sfm_mvs_tpu`` blocked from import,
every module of ``sfm_mvs_tpu_torch`` imports (the CLI, the native loader,
MVS, the view graph and stitching, the five-point solver, the global
pipeline, the LK tracker, the KLT pipeline, the profiling hooks and every
module of ``parallel`` among them), the CLI's parser takes the flags the
GPU smoke run gives it, and a small detect + match runs on the CPU.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None          # any `import jax` now raises ImportError
    sys.modules["sfm_mvs_tpu"] = None
    import torch
    torch.set_num_threads(1)
    import sfm_mvs_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(sfm_mvs_tpu_torch.__path__,
                                                   "sfm_mvs_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    for name in ("cli", "native", "models.mvs", "models.exhaustive", "ops.five_point",
                 "models.tracks", "ops.optical_flow", "models.klt", "utils.profiling",
                 "parallel.mesh", "parallel.multihost", "parallel.consistency",
                 "parallel.distributed_ba", "parallel.sharded_map", "parallel.frontend"):
        assert "sfm_mvs_tpu_torch." + name in names
    from sfm_mvs_tpu_torch import cli
    args = cli.build_parser().parse_args([
        "--image-dir", "frames", "--out", "out", "--fx", "1200", "--fy", "1200",
        "--cx", "484", "--cy", "324", "--downscale", "1", "--max-features", "4096",
        "--lowe-ratio", "0.75", "--contrast-threshold", "0.012", "--max-cameras", "64",
        "--max-points", "16384", "--bootstrap", "auto", "--ba", "--ba-iterations", "8",
        "--finalize", "--sweep", "--sweep-contrast", "0.0025", "--densify", "--no-gif",
        "--device", "cuda", "--essential-solver", "5pt", "--grad-sampling", "bilinear",
        "--loop-close", "4", "--ba-refine-intrinsics", "--ba-refine-intrinsics-per-camera",
        "--pipeline", "global"])
    cfg = cli.config_from_args(args)
    assert (cfg.bootstrap, cfg.ba.enabled, cfg.sweep.enabled, args.densify, args.device) == (
        "auto", True, True, True, "cuda")
    assert (cfg.ransac.essential_solver, cfg.frontend.grad_sampling, cfg.loop_close_pairs,
            cfg.ba.refine_intrinsics, cfg.ba.refine_intrinsics_per_camera, args.pipeline) == (
        "5pt", "bilinear", 4, True, True, "global")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    from sfm_mvs_tpu_torch.ops import matching, sift
    from sfm_mvs_tpu_torch.utils.config import FrontendConfig
    from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence
    imgs, _, _ = render_staircase_sequence(num_cameras=2, image_size=(160, 120),
                                           focal=200.0, arc_degrees=6, texture_size=256)
    cfg = FrontendConfig(max_features=128, num_octaves=2, contrast_threshold=0.015)
    f0, f1 = (sift.detect_and_compute(torch.as_tensor(im), cfg) for im in imgs)
    m = matching.match_with_config(f0.desc, f1.desc, f0.valid, f1.valid, cfg)
    assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
    print(len(names), int(f0.valid.sum()), int(m.valid.sum()))
""")


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, n_kp, n_matches = map(int, out.stdout.split())
    assert n_modules >= 48
    assert n_kp > 20 and n_matches > 10
