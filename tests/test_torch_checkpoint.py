"""Checkpoints against the JAX package (utils/checkpoint.py) and resume.

A checkpoint written by either package loads in the other with every array
equal, dtypes included (the .npz keys map_*, feat_*, prev_track and
frame_index; float32, int32 and bool). A run resumed from a checkpoint
draws each frame's random stream from (seed, frame), so it ends on a map
bitwise equal to the uninterrupted run's.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from _torch_parity import N, ba_map

from sfm_mvs_tpu.models.incremental import PipelineState as JPipelineState
from sfm_mvs_tpu.ops.sift import Features as JFeatures
from sfm_mvs_tpu.utils import checkpoint as jckpt
from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM
from sfm_mvs_tpu_torch.utils import checkpoint as ckpt
from sfm_mvs_tpu_torch.utils import config, evaluate
from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence


@pytest.fixture(scope="module")
def jax_pipeline():
    rng = np.random.default_rng(0)
    k = 64
    feats = JFeatures(
        xy=jnp.asarray(rng.uniform(0, 300, (k, 2)).astype(np.float32)),
        scale=jnp.asarray(rng.uniform(1, 4, k).astype(np.float32)),
        angle=jnp.asarray(rng.uniform(-3, 3, k).astype(np.float32)),
        response=jnp.asarray(rng.uniform(0, 1, k).astype(np.float32)),
        desc=jnp.asarray(rng.random((k, 128)).astype(np.float32)),
        valid=jnp.asarray(rng.random(k) > 0.3))
    track = jnp.asarray(rng.integers(-1, 300, k).astype(np.int32))
    return JPipelineState(map=ba_map(), prev_feats=feats, prev_track=track)


def _leaves(ps):
    return [("prev_track", ps.prev_track)] + \
        [(f"map_{k}", v) for k, v in ps.map._asdict().items()] + \
        [(f"feat_{k}", v) for k, v in ps.prev_feats._asdict().items()]


def _assert_same(ours, ref):
    for (name, a), (_, b) in zip(_leaves(ours), _leaves(ref)):
        a, b = N(a), N(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_checkpoints_move_both_ways(jax_pipeline, tmp_path):
    jps = jax_pipeline
    jckpt.save_pipeline(str(tmp_path / "j" / "frame_00007.npz"), jps, 7)
    ps, frame = ckpt.load_pipeline(str(tmp_path / "j" / "frame_00007.npz"), device="cpu")
    assert frame == 7
    _assert_same(ps, jps)

    ckpt.save_pipeline(str(tmp_path / "t" / "frame_00009.npz"), ps, 9)
    with np.load(tmp_path / "t" / "frame_00009.npz") as z, \
            np.load(tmp_path / "j" / "frame_00007.npz") as zj:
        assert sorted(z.files) == sorted(zj.files)
    jps2, frame2 = jckpt.load_pipeline(str(tmp_path / "t" / "frame_00009.npz"))
    assert frame2 == 9
    _assert_same(jps2, jps)

    ckpt.save_map(str(tmp_path / "m.npz"), ps.map)
    jm = jckpt.load_map(str(tmp_path / "m.npz"))
    tm = ckpt.load_map(str(tmp_path / "m.npz"), device="cpu")
    for name, a, b, c in zip(jm._fields, tm, jm, jps.map):
        np.testing.assert_array_equal(N(a), N(c), err_msg=name)
        np.testing.assert_array_equal(N(b), N(c), err_msg=name)
    assert ckpt.latest_checkpoint(str(tmp_path / "t")).endswith("frame_00009.npz")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_resumed_run_equals_uninterrupted(tmp_path):
    imgs, Rt, K = render_staircase_sequence(num_cameras=6, arc_degrees=24,
                                            image_size=(200, 150), focal=250.0)
    cfg = config.SfmConfig(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
        downscale=1,
        frontend=config.FrontendConfig(max_features=512, num_octaves=3,
                                       contrast_threshold=0.015, lowe_ratio=0.75),
        ransac=config.RansacConfig(essential_iters=256, pnp_iters=256, homography_iters=256),
        map=config.MapConfig(max_cameras=8, max_points=4096),
        ba=config.BaConfig(enabled=True, max_iterations=5))
    full = IncrementalSfM(cfg, device="cpu", checkpoint_dir=str(tmp_path), checkpoint_every=2)
    s_full = full.run(imgs)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["frame_00002.npz", "frame_00004.npz"]
    ps, frame = ckpt.load_pipeline(str(tmp_path / "frame_00002.npz"), device="cpu")
    assert frame == 2
    resumed = IncrementalSfM(cfg, device="cpu")
    s_res = resumed.run(imgs, resume_state=ps, resume_frame=frame)
    assert [s["frame"] for s in resumed.stats] == [3, 4, 5]
    for name, a, b in zip(s_full._fields, s_res, s_full):
        np.testing.assert_array_equal(N(a), N(b), err_msg=name)
    cv = N(s_full.cam_valid)
    assert cv.sum() == 6
    assert evaluate.ate_rmse(N(s_full.poses)[cv], Rt) < 0.05
