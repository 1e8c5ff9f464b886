"""gustav57-viewgraph with a step broken underneath has to come out as not
correct, each fault caught by the number that belongs to it (the style of
``test_faults.py``): the harness drives the tiny cell on the CPU while the
port's view graph, bootstrap guard, loop closure or finalize is broken."""

import math

import pytest
import torch

from portbench.tests import tiny

CELL = "gustav57-viewgraph"


def _k1_answer_altered(mp):
    from sfm_mvs_tpu_torch.models import exhaustive

    orig = exhaustive._match

    def broken(f0, f1, cfg):
        m = orig(f0, f1, cfg)
        i = int(torch.nonzero(m.valid)[0, 0])
        idx1 = m.idx1.clone()
        idx1[i] = (idx1[i] + 1) % f1.desc.shape[0]
        return m._replace(idx1=idx1)

    mp.setattr(exhaustive, "_match", broken)


def _inlier_count_inflated(mp):
    from sfm_mvs_tpu_torch.models import exhaustive

    orig = exhaustive._pair_geometry

    def broken(*a, **kw):
        nm, ni, R, t, px = orig(*a, **kw)
        return nm, ni + ni // 5 + 1, R, t, px

    mp.setattr(exhaustive, "_pair_geometry", broken)


def _eight_point_in_bfloat16(mp):
    """The 8-point solves see their correspondences rounded to bfloat16."""
    from sfm_mvs_tpu_torch.ops import epipolar

    orig = epipolar.essential_eight_point

    def broken(pts1, pts2, weights=None, method="svd"):
        def rounded(x):
            return x.to(torch.bfloat16).to(x.dtype)
        return orig(rounded(pts1), rounded(pts2), weights, method)

    mp.setattr(epipolar, "essential_eight_point", broken)


def _rotation_transposed(mp):
    from sfm_mvs_tpu_torch.models import exhaustive

    orig = exhaustive._pair_geometry

    def broken(*a, **kw):
        nm, ni, R, t, px = orig(*a, **kw)
        return nm, ni, R.T, t, px

    mp.setattr(exhaustive, "_pair_geometry", broken)


def _parallax_scaled(mp):
    from sfm_mvs_tpu_torch.models import exhaustive

    orig = exhaustive._pair_geometry

    def broken(*a, **kw):
        nm, ni, R, t, px = orig(*a, **kw)
        return nm, ni, R, t, px * 1.1

    mp.setattr(exhaustive, "_pair_geometry", broken)


def _guard_skipped(mp):
    """The bootstrap's first try comes back turned by 10 deg and the guard
    keeps it without looking."""
    from sfm_mvs_tpu_torch.models import exhaustive, incremental

    own = incremental.bootstrap

    def turned(gen, f0, f1, K, cfg):
        tv = own(gen, f0, f1, K, cfg)
        a = math.radians(10.0)
        turn = torch.tensor([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                             [-math.sin(a), 0.0, math.cos(a)]], dtype=tv.pose1.dtype,
                            device=tv.pose1.device)
        return tv._replace(pose1=torch.cat([turn @ tv.pose1[:, :3], tv.pose1[:, 3:]], 1))

    def unguarded(self, graph, feats, images_bgr, K, seed):
        a, b = exhaustive.bootstrap_candidates(graph)[0]
        out = incremental.init_from_bootstrap(
            incremental.frame_generator(self.device, seed, b), feats[a], feats[b],
            self._bgr(images_bgr[b]), K, self.config, return_track0=True)
        poses = out[0].map.poses
        idx = exhaustive.pair_index(graph, a, b)
        rot, dirn = exhaustive.pose_disagreement(poses[0], poses[1], graph.R[idx], graph.t[idx])
        self.bootstrap_attempts = [incremental.BootstrapAttempt(a, b, 0, poses[1], rot, dirn)]
        return (a, b), out

    mp.setattr(incremental, "bootstrap", turned)
    mp.setattr(incremental.IncrementalSfM, "_guarded_bootstrap", unguarded)


def _weakest_loop_pairs(mp):
    from sfm_mvs_tpu_torch.models import exhaustive

    def broken(graph, top_k, min_gap=3, min_inliers=30):
        import numpy as np

        gaps = np.abs(graph.pair_j - graph.pair_i)
        cand = np.where(gaps >= min_gap)[0]
        cand = cand[np.argsort(graph.num_inliers[cand], kind="stable")][:top_k]
        return [(int(graph.pair_i[i]), int(graph.pair_j[i])) for i in cand]

    mp.setattr(exhaustive, "strongest_loop_pairs", broken)


def _injected_pixels_moved(mp):
    from sfm_mvs_tpu_torch.models import exhaustive

    orig = exhaustive.inject_reobservations

    def broken(state, cam_i, cam_j, *a, **kw):
        new, n = orig(state, cam_i, cam_j, *a, **kw)
        added = new.obs_mask[:, cam_j] & ~state.obs_mask[:, cam_j]
        uv = new.obs_uv.clone()
        uv[added, cam_j] += 100.0  # every injected observation 141 px off its match
        return new._replace(obs_uv=uv), n

    mp.setattr(exhaustive, "inject_reobservations", broken)


def _points_moved_after_finalize(mp):
    from sfm_mvs_tpu_torch.models import incremental

    orig = incremental.finalize_map

    def broken(state, **kw):
        out, info = orig(state, **kw)
        return out._replace(points=out.points * 1.01), info  # the cost reported is the BA's

    mp.setattr(incremental, "finalize_map", broken)


def _camera_moved_after_finalize(mp):
    from sfm_mvs_tpu_torch.models import incremental

    orig = incremental.IncrementalSfM.finalize

    def broken(self, *a, **kw):
        out = orig(self, *a, **kw)
        poses = out.poses.clone()
        poses[int(out.num_cams) - 1, 0, 3] += 1.0  # the last camera 1 unit off its place
        return out._replace(poses=poses)

    mp.setattr(incremental.IncrementalSfM, "finalize", broken)


def _a_camera_dropped_by_finalize(mp):
    from sfm_mvs_tpu_torch.models import incremental

    orig = incremental.IncrementalSfM.finalize

    def broken(self, *a, **kw):
        out = orig(self, *a, **kw)
        valid = out.cam_valid.clone()
        valid[int(out.num_cams) - 1] = False  # the run still reports the frame posed
        return out._replace(cam_valid=valid)

    mp.setattr(incremental.IncrementalSfM, "finalize", broken)


def _a_frame_rejected(mp):
    from sfm_mvs_tpu_torch.models import incremental

    orig = incremental.register_frame
    calls = []

    def broken(*a, **kw):
        new, st = orig(*a, **kw)
        calls.append(1)
        if len(calls) == 3:
            return new, st._replace(accepted=torch.zeros_like(st.accepted))
        return new, st

    mp.setattr(incremental, "register_frame", broken)


FAULTS = [
    (_k1_answer_altered, "k1_gap"),
    (_inlier_count_inflated, "pair_inlier_gap"),
    (_eight_point_in_bfloat16, "essential_solve_gap"),
    (_rotation_transposed, "pair_pose_gap"),
    (_parallax_scaled, "parallax_gap"),
    (_guard_skipped, "bootstrap_pair_mismatch"),
    (_weakest_loop_pairs, "loop_pairs_mismatch"),
    (_injected_pixels_moved, "inject_gap"),
    (_points_moved_after_finalize, "finalize_cost_gap"),
    (_camera_moved_after_finalize, "pose_ate"),
    (_a_frame_rejected, "unregistered"),
    (_a_camera_dropped_by_finalize, "unregistered"),
]


@pytest.mark.parametrize("fault,check", FAULTS, ids=[f.__name__.lstrip("_") for f, _ in FAULTS])
def test_a_broken_step_is_not_correct(monkeypatch, fault, check):
    fault(monkeypatch)
    res = tiny.run_tiny(CELL, seconds=1.0)
    c = res["checks"][check]
    assert not res["correct"]
    assert not c["value"] <= c["limit"], res["checks"]
