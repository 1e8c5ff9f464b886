"""The port's ``parallel`` package at 2 gloo ranks against the JAX package.

One 2-rank job (tests/_torch_parallel_worker.py, each rank a process on the
CPU) runs every sharded path of the port once; the cases below compare its
results with the port's single-process functions and with the JAX
package's sharded functions on conftest's 8-device virtual mesh, on the
inputs of tests/test_parallel.py, test_consistency.py and test_mvs.py.

Tolerances are those of the JAX package's own sharded tests: BA initial
cost rel 1e-5, final cost rel 1e-2, poses 1e-4, points 1e-3
(tests/test_parallel.py:83-101; the reductions sum the point blocks in
another order, so the trajectory agrees to rounding, not bitwise); camera
state bitwise equal across ranks; detection xy 1e-4 and valid equal per
frame (tests/test_parallel.py:24-40), and against the JAX detector
tests/test_torch_sift.py's margins (counts within 1%, >= 99% of positions
within 1e-3 px); matches identical wherever the pair's decision is not a
rounding tie; the sharded MVS cloud within max(5, n/100) points and
> 98% rounded-point overlap of the unsharded one (tests/test_mvs.py:149-155).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parallel_worker import Ranks
from _torch_parity import N, T

from sfm_mvs_tpu.models import map_store as jms
from sfm_mvs_tpu.ops import sift as jsift
from sfm_mvs_tpu.parallel import consistency as jconsistency
from sfm_mvs_tpu.parallel import distributed_ba as jdba
from sfm_mvs_tpu.parallel import frontend as jfrontend
from sfm_mvs_tpu.parallel import mesh as jmeshlib
from sfm_mvs_tpu.utils import config as jconfig
from sfm_mvs_tpu.utils.synthetic import make_scene, render_staircase_sequence
from sfm_mvs_tpu_torch.models import ba, map_store, mvs
from sfm_mvs_tpu_torch.ops import lie, sift
from sfm_mvs_tpu_torch.ops.sift import Features
from sfm_mvs_tpu_torch.parallel import consistency, multihost
from sfm_mvs_tpu_torch.utils.config import FrontendConfig, MapConfig

FRONTEND = dict(max_features=256, num_octaves=2, upsample_input=False,
                contrast_threshold=0.015, lowe_ratio=0.8)


def _ba_state(C=4, P=256):
    """tests/test_parallel.py's _ba_state (rng seed 0), built with the port's
    map store: (JAX MapState, port MapState) of the same numbers."""
    rng = np.random.default_rng(0)
    scene = make_scene(num_points=P, num_cameras=C, arc_degrees=40)
    state = map_store.init_map(T(scene.K), MapConfig(max_cameras=8, max_points=512))
    for c in range(C):
        state, _ = map_store.append_camera(state, T(scene.Rt[c]))
    Xn = scene.points + rng.normal(scale=0.05, size=(P, 3)).astype(np.float32)
    state, pids = map_store.append_points(state, T(Xn), torch.zeros(P, 3),
                                          torch.ones(P, dtype=torch.bool))
    for c in range(C):
        uv, _ = scene.project(c)
        state = map_store.append_observations(state, c, pids, T(uv.astype(np.float32)),
                                              torch.ones(P, dtype=torch.bool))
    rv, tv = lie.matrix_to_rt(T(scene.Rt[1]))
    poses = state.poses.clone()
    poses[1] = lie.rt_to_matrix(rv + 0.02, tv + 0.05)
    return _both(state._replace(poses=poses))


def _both(state):
    """(JAX MapState, port MapState) holding the port state's numbers."""
    return jms.MapState(*[jnp.asarray(N(a)) for a in state]), state


def _mvs_state():
    """tests/test_mvs.py's densification scene: 3 frames at 160x120 and a
    sparse map seeded from ground-truth depth (port MapState)."""
    imgs, Rt, K, depths = render_staircase_sequence(num_cameras=3, arc_degrees=10,
                                                    image_size=(160, 120), focal=200.0,
                                                    return_depth=True)
    state = map_store.init_map(T(K), MapConfig(max_cameras=4, max_points=4096))
    for c in range(3):
        state, _ = map_store.append_camera(state, T(Rt[c]))
    rng = np.random.default_rng(0)
    ys, xs = rng.integers(0, 120, 300), rng.integers(0, 160, 300)
    z = depths[1][ys, xs]
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    Xw = (rays * z[:, None] - Rt[1][:, 3]) @ Rt[1][:, :3]
    state, _ = map_store.append_points(state, T(Xw.astype(np.float32)), torch.zeros(300, 3),
                                       T(z > 0))
    return [np.asarray(g, np.float32) for g in imgs], state


def _arrays(state):
    return [N(a) for a in state]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Starts the 2-rank job, computes the references while it runs, and
    returns (each rank's results, the references)."""
    js, ts = _ba_state()
    frames = np.stack(render_staircase_sequence(num_cameras=8, image_size=(160, 128))[0])
    cfg = FrontendConfig(**FRONTEND)
    port_batch = sift.detect_batch(T(frames), cfg)
    pair0 = np.arange(8, dtype=np.int32) % 7
    pair1 = pair0 + 1
    mvs_frames, mvs_state = _mvs_state()
    ranks = Ranks("parallel", dict(
        ba_state=_arrays(ts), frontend_cfg=FRONTEND, frames=frames,
        feats=_arrays(port_batch), pair0=pair0, pair1=pair1,
        mvs_frames=mvs_frames, mvs_state=_arrays(mvs_state),
    ), str(tmp_path_factory.mktemp("ranks")))

    mesh8 = jmeshlib.make_mesh((8,), ("data",))
    ref = {"frames": frames, "port_batch": port_batch, "pairs": (pair0, pair1)}
    ref["port_map"] = ba.bundle_adjust_map(ts, max_iterations=8, cg_iters=15)
    ref["jax_map"] = jdba.bundle_adjust_map_sharded(js, mesh8, max_iterations=8, cg_iters=15)
    wkw = dict(window_cams=4, window_points=512, max_iterations=6, cg_iters=12, freeze_cams=1)
    ref["port_window"] = ba.bundle_adjust_window(ts, **wkw)
    ref["jax_window"] = jdba.bundle_adjust_window_sharded(js, mesh8, **wkw)
    ref["per_frame"] = [sift.detect_and_compute(T(f), cfg) for f in frames]
    jcfg = jconfig.FrontendConfig(**FRONTEND)
    ref["jax_feats"] = jfrontend.detect_batch(jnp.asarray(frames), jcfg)
    jf = jsift.Features(*[jnp.asarray(N(a)) for a in port_batch])
    ref["jax_match"] = jfrontend.match_pairs_sharded(jf, jnp.asarray(pair0), jnp.asarray(pair1),
                                                     mesh8, jcfg)
    ref["mvs"] = mvs.densify_map(mvs_frames, mvs_state, num_depths=48, stride=4)
    return ranks.results(), ref


def _ba_close(port_state, stats, ref_state, ref_stats):
    assert float(stats[0]) == pytest.approx(float(ref_stats.initial_cost), rel=1e-5)
    assert float(stats[1]) == pytest.approx(float(ref_stats.final_cost), rel=1e-2, abs=1e-6)
    np.testing.assert_allclose(port_state[0], N(ref_state.poses), atol=1e-4)
    np.testing.assert_allclose(port_state[1], N(ref_state.points), atol=1e-3)


@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("kind", ["map", "window"])
def test_sharded_ba_matches(job, kind, ref):
    """bundle_adjust_map_sharded / bundle_adjust_window_sharded at 2 ranks
    against the port's single-process BA and the JAX package's sharded BA."""
    ranks, refs = job
    ref_state, ref_stats = refs[f"{ref}_{kind}"]
    for r in ranks:
        poses, points, stats = r[f"{kind}_ba"]
        _ba_close((poses, points), stats, ref_state, ref_stats)
    assert float(ref_stats.final_cost) < 0.1 * float(ref_stats.initial_cost)


def test_ranks_hold_the_same_bits(job):
    """Camera state, the whole map and the stats are bitwise equal across
    ranks; check_ba_replication passes on every rank."""
    ranks, _ = job
    assert [r["rank"] for r in ranks] == [0, 1] and ranks[0]["backend"] == "gloo"
    for r in ranks:
        assert r["replicated"] == "" and not r["jax_loaded"]
    np.testing.assert_array_equal(ranks[0]["cam_params"], ranks[1]["cam_params"])
    assert ranks[0]["map_fingerprint"] == ranks[1]["map_fingerprint"]
    for kind in ("map_ba", "window_ba"):
        for a, b in zip(ranks[0][kind], ranks[1][kind]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_assert_replicated_catches_divergence(job):
    """A replica that differs on rank 1 raises on every rank; checksums of a
    replicated array equal the JAX package's per-device ones."""
    ranks, _ = job
    for r in ranks:
        assert "replication divergence in x" in r["diverged"]
        assert "rank0=0.0" in r["diverged"]
    jx = jax.device_put(jnp.arange(64.0), jax.sharding.NamedSharding(
        jmeshlib.make_mesh((8,), ("data",)), jax.sharding.PartitionSpec()))
    assert ranks[0]["checksums"] == jconsistency.device_checksums(jx)[:2]


def test_prob_intr_matches_jax():
    from sfm_mvs_tpu.parallel.distributed_ba import prob_intr as jprob_intr
    from sfm_mvs_tpu_torch.parallel.distributed_ba import prob_intr

    np.testing.assert_array_equal(N(prob_intr()), N(jprob_intr(jnp.float32)))
    assert prob_intr().dtype == torch.float32


def test_state_fingerprint_matches_jax():
    """Equal arrays give the JAX package's hex, over a MapState and a dict
    tree (sorted keys); one changed bit changes it."""
    js, ts = _ba_state()
    assert consistency.state_fingerprint(ts) == jconsistency.state_fingerprint(js)
    tree = {"b": torch.ones(3, 3), "a": torch.arange(5.0), "c": [torch.tensor([True, False])]}
    jtree = {"b": jnp.ones((3, 3)), "a": jnp.arange(5.0), "c": [jnp.asarray([True, False])]}
    assert consistency.state_fingerprint(tree) == jconsistency.state_fingerprint(jtree)
    tree["a"] = tree["a"] + 1e-6
    assert consistency.state_fingerprint(tree) != jconsistency.state_fingerprint(jtree)


def test_detect_batch_matches_per_frame(job):
    """sift.detect_batch over 8 frames against detect_and_compute per frame:
    every field equal (NaN in invalid slots aside)."""
    _, refs = job
    for b, single in enumerate(refs["per_frame"]):
        for name, x, y in zip(Features._fields, refs["port_batch"], single):
            x, y = N(x[b]), N(y)
            assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), (b, name)


def test_detect_batch_sharded(job):
    """detect_batch_sharded at 2 ranks: every rank holds all 8 frames, xy
    within 1e-4 and valid equal to per-frame detection."""
    ranks, refs = job
    for r in ranks:
        feats = r["detect"]
        assert feats.xy.shape == (8, 256, 2) and feats.desc.shape == (8, 256, 128)
        for b, single in enumerate(refs["per_frame"]):
            np.testing.assert_array_equal(feats.valid[b], N(single.valid))
            v = feats.valid[b]
            np.testing.assert_allclose(feats.xy[b][v], N(single.xy)[v], atol=1e-4)
            assert v.sum() > 20


def test_detect_batch_matches_jax(job):
    """The port's detect_batch against the JAX package's vmapped detector,
    frame by frame at test_torch_sift.py's margins."""
    _, refs = job
    ours, ref = refs["port_batch"], refs["jax_feats"]
    for b in range(8):
        v, vj = N(ours.valid[b]), N(ref.valid[b])
        assert abs(int(v.sum()) - int(vj.sum())) <= max(1, int(0.01 * vj.sum()))
        d = np.linalg.norm(N(ref.xy[b])[vj][:, None] - N(ours.xy[b])[v][None], axis=-1)
        assert (d.min(1) < 1e-3).mean() >= 0.99


def test_match_pairs_sharded_matches_jax(job):
    """match_pairs_sharded at 2 ranks (each rank's 4 pairs in one batched
    matcher call) against the JAX package's on the same features (the
    port's detect_batch of tests/test_parallel.py's frames): idx1 and
    valid equal wherever the decision is not a rounding tie (>= 99% of
    rows), and every adjacent pair keeps >= 8 matches as in
    tests/test_parallel.py."""
    ranks, refs = job
    ref = refs["jax_match"]
    f = refs["port_batch"]
    p0, p1 = refs["pairs"]
    d0 = N(f.desc).astype(np.float64)[p0]
    d1 = N(f.desc).astype(np.float64)[p1]
    dist = np.maximum((d0 ** 2).sum(-1)[..., None] + (d1 ** 2).sum(-1)[:, None]
                      - 2 * d0 @ d1.transpose(0, 2, 1), 0)
    dist = np.where(N(f.valid)[p1][:, None, :], dist, 3e38)
    srt = np.sort(dist, -1)
    clear = ((srt[..., 1] - srt[..., 0]) > 1e-5) & (
        np.abs(srt[..., 0] - 0.64 * srt[..., 1]) > 1e-5)
    assert clear.mean() >= 0.99
    for r in ranks:
        m = r["match"]
        assert m.idx1.shape == (8, 256)
        np.testing.assert_array_equal(m.idx0, N(ref.idx0))
        np.testing.assert_array_equal(m.valid[clear], N(ref.valid)[clear])
        both = clear & N(ref.valid)
        np.testing.assert_array_equal(m.idx1[both], N(ref.idx1)[both])
        assert m.valid.sum(1).min() >= 8


def test_densify_map_sharded(job):
    """densify_map(mesh=) at 2 ranks against the unsharded port: the same
    cloud on both ranks, within tests/test_mvs.py:149-155's bounds."""
    ranks, refs = job
    pts_1, _ = refs["mvs"]
    assert len(pts_1) > 400
    np.testing.assert_array_equal(ranks[0]["mvs"][0], ranks[1]["mvs"][0])
    for r in ranks:
        pts_sh, cols = r["mvs"]
        assert cols.shape == pts_sh.shape
        assert abs(len(pts_sh) - len(pts_1)) <= max(5, len(pts_1) // 100)
        key_sh = {tuple(np.round(p, 3)) for p in pts_sh}
        key_1 = {tuple(np.round(p, 3)) for p in pts_1}
        assert len(key_sh & key_1) / max(len(key_1), 1) > 0.98


def test_slice_mesh_and_placements(job):
    """slice_mesh at 2 ranks as 2 hosts x 1 and 1 host x 2: each rank's row
    (ici) and column (dcn) groups; ba_shardings blocks the point arrays."""
    ranks, _ = job
    for r in ranks:
        me = r["rank"]
        assert r["slices"][0] == (2, 1, 1, 0, 2, me)
        assert r["slices"][1] == (1, 2, 2, me, 1, 0)
    placements = multihost.ba_shardings(multihost.SliceMesh(1, 2, None, None))
    assert placements["points"][0] == ("points", "point_valid", "obs_uv", "obs_mask")
    assert placements["cameras"] == (("cam_params", "cam_valid", "K", "frozen", "intr"), None)


def test_initialize_without_env_is_a_noop(monkeypatch):
    """multihost.initialize returns False and starts nothing when torch's
    env vars are absent or name a world of one, and refuses a larger world
    without this process's rank."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize(backend="gloo") is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize(backend="gloo") is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK"):
        multihost.initialize(backend="gloo")
    assert not torch.distributed.is_initialized()


def test_incremental_run_batch_detect():
    """IncrementalSfM.run(batch_detect=3) detects in padded chunks through
    frontend.detect_batch and registers the same map as per-frame detection
    (4 frames at 320x240: chunks [0, 1, 2] and [3, 3, 3])."""
    from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM
    from sfm_mvs_tpu_torch.utils import config

    imgs, _, K = render_staircase_sequence(num_cameras=4, arc_degrees=20, image_size=(320, 240))
    cfg = config.SfmConfig(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]), downscale=1,
        frontend=FrontendConfig(max_features=512, num_octaves=3, contrast_threshold=0.015,
                                lowe_ratio=0.75),
        ransac=config.RansacConfig(essential_iters=256, pnp_iters=256, homography_iters=256),
        map=MapConfig(max_cameras=8, max_points=4096))
    per_frame = IncrementalSfM(cfg, device="cpu").run(imgs)
    batched = IncrementalSfM(cfg, device="cpu").run(imgs, batch_detect=3)
    assert int(per_frame.cam_valid.sum()) == 4
    for name, x, y in zip(per_frame._fields, per_frame, batched):
        assert torch.equal(x, y), name
