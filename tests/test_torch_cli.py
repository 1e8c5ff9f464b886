"""The port's command line (cli.py) end to end on the CPU.

``cli.main`` runs on PNGs written with PIL, with BA, finalize, the sweep,
MVS densification and checkpoints, once with the sequential bootstrap and
once with the view-graph one: it must return 0, write every artifact the
JAX package's CLI writes, log the metrics events, and leave a pose.csv of
9 + 12 values per camera whose trajectory is within ATE 0.05 of ground
truth. The remaining flags run too: --pipeline global (rc 0, a finite
pose.csv), and --essential-solver 5pt --grad-sampling bilinear
--loop-close 2 --ba-refine-intrinsics-per-camera (ATE < 0.05, loop-closure
observations, camera 0's intrinsics the identity). --device cuda without
CUDA raises.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import _torch_parity  # noqa: F401  (one torch thread)

from sfm_mvs_tpu_torch import cli
from sfm_mvs_tpu_torch.utils import evaluate, io
from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence

N_FRAMES = 6


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    imgs, Rt, K = render_staircase_sequence(num_cameras=N_FRAMES, arc_degrees=24,
                                            image_size=(200, 150), focal=250.0)
    for i, im in enumerate(imgs):
        Image.fromarray((np.clip(im, 0, 1) * 255).astype(np.uint8)).save(d / f"img_{i:03d}.png")
    return str(d), Rt, K


def _args(frames, out, *flags):
    d, _, K = frames
    return ["--image-dir", d, "--out", str(out), "--device", "cpu",
            "--fx", str(K[0, 0]), "--fy", str(K[1, 1]), "--cx", str(K[0, 2]),
            "--cy", str(K[1, 2]), "--downscale", "1", "--max-features", "512",
            "--lowe-ratio", "0.75", "--contrast-threshold", "0.015", "--max-cameras", "8",
            "--max-points", "4096", "--ba-iterations", "5", "--sweep-grow", "8192", *flags]


FULL = ["--ba", "--finalize", "--sweep", "--densify", "--checkpoint-every", "2", "--no-gif"]


@pytest.mark.parametrize("bootstrap", ["seq", "auto"])
def test_cli_end_to_end(frames, tmp_path, bootstrap):
    out = tmp_path / "out"
    argv = _args(frames, out, "--bootstrap", bootstrap, *FULL)
    if bootstrap == "auto":  # as in the JAX package: no periodic checkpoints
        with pytest.warns(UserWarning, match="checkpoints are not written"):
            rc = cli.main(argv)
    else:
        rc = cli.main(argv)
    assert rc == 0
    names = ["sparse.ply", "dense.ply", "pose.csv", "cameras.ply", "metrics.jsonl"]
    if importlib.util.find_spec("matplotlib") is not None:  # else skipped with a warning
        names.append("reproj_error.png")
    for name in names:
        assert (out / name).stat().st_size > 0, name
    ckpts = sorted(os.listdir(out / "checkpoints")) if (out / "checkpoints").exists() else []
    assert ckpts == (["frame_00002.npz", "frame_00004.npz"] if bootstrap == "seq" else [])

    with open(out / "metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    events = {r["event"] for r in records}
    assert {"frame", "ba", "finalize"} <= events
    assert ("bootstrap_auto" in events) == (bootstrap == "auto")
    assert sum(r["event"] == "frame" for r in records) == N_FRAMES - 1

    assert len(np.loadtxt(out / "pose.csv")) == 9 + 12 * N_FRAMES
    K, P = io.load_pose_csv(str(out / "pose.csv"))
    poses = io.poses_from_projections(K, P)
    assert evaluate.ate_rmse(poses.astype(np.float32), frames[1]) < 0.05
    sparse, _ = io.read_ply(str(out / "sparse.ply"))
    dense, _ = io.read_ply(str(out / "dense.ply"))
    assert len(sparse) > 100 and len(dense) > 1000 and np.isfinite(dense).all()


def _poses(out):
    assert len(np.loadtxt(out / "pose.csv")) == 9 + 12 * N_FRAMES
    K, P = io.load_pose_csv(str(out / "pose.csv"))
    return io.poses_from_projections(K, P).astype(np.float32)


def test_cli_global_pipeline(frames, tmp_path, capsys):
    """--pipeline global: tracks, global BA and the final sweep, then
    --finalize's cull + BA; the incremental-only --loop-close is ignored
    with a warning."""
    out = tmp_path / "out"
    rc = cli.main(_args(frames, out, "--pipeline", "global", "--finalize", "--loop-close", "2",
                        "--no-gif"))
    assert rc == 0
    assert "ignored with --pipeline global" in capsys.readouterr().err
    poses = _poses(out)
    assert np.isfinite(poses).all()
    with open(out / "metrics.jsonl") as fh:
        assert not [json.loads(line) for line in fh]  # the global driver logs no events
    sparse, _ = io.read_ply(str(out / "sparse.ply"))
    assert len(sparse) > 100


def test_cli_five_point_bilinear_loop_closure_percam(frames, tmp_path):
    """The incremental path with every remaining flag: the 5-point solver,
    bilinear SIFT sampling, loop closure and per-camera intrinsics."""
    out = tmp_path / "out"
    rc = cli.main(_args(frames, out, "--essential-solver", "5pt", "--grad-sampling", "bilinear",
                        "--loop-close", "2", "--ba", "--ba-refine-intrinsics-per-camera",
                        "--no-gif"))
    assert rc == 0
    assert evaluate.ate_rmse(_poses(out), frames[1]) < 0.05
    with open(out / "metrics.jsonl") as fh:
        fin = [r for r in map(json.loads, fh) if r["event"] == "finalize"][0]
    assert fin["loop_closure_obs"] > 0 and "merged_points" in fin and "robust_cost" in fin
    intr = np.asarray(fin["intrinsics_per_camera"])
    assert intr.shape == (N_FRAMES, 3) and intr[0].tolist() == [1.0, 0.0, 0.0]
    assert fin["final_cost"] < 1.0


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is available here")
def test_device_cuda_without_cuda_raises(frames, tmp_path):
    argv = [a if a != "cpu" else "cuda" for a in _args(frames, tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
    assert not (tmp_path / "out").exists()
