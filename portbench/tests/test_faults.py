"""A run with its timed path broken underneath has to come out as not
correct: the harness drives a tiny cell on the CPU (skipping its look for
a card) while a step of the port is broken, and the check that the fault
belongs to reads over its limit. A sound run of the same size passes."""

import pytest
import torch

from portbench.tests import tiny


def _ba_state_unchanged(mp):
    from sfm_mvs_tpu_torch.models import ba

    orig = ba.bundle_adjust_map

    def broken(state, *a, **kw):
        _, stats = orig(state, *a, **kw)
        return state, stats  # the map as it came in, the solve's report

    mp.setattr(ba, "bundle_adjust_map", broken)


def _ba_input_with_its_cost(mp):
    from sfm_mvs_tpu_torch.models import ba

    orig = ba.bundle_adjust_map

    def broken(state, *a, **kw):
        _, stats = orig(state, *a, **kw)
        return state, stats._replace(final_cost=stats.initial_cost)  # no descent, told truly

    mp.setattr(ba, "bundle_adjust_map", broken)


def _triangulation_altered(mp):
    from sfm_mvs_tpu_torch.ops import triangulation

    orig = triangulation.triangulate_euclidean

    def broken(*a, **kw):
        return orig(*a, **kw) * 1.01  # every new point 1% farther from the origin

    mp.setattr(triangulation, "triangulate_euclidean", broken)


def _register_state_unchanged(mp):
    from sfm_mvs_tpu_torch.models import incremental

    orig = incremental.register_frame

    def broken(gen, pstate, feats, *a, **kw):
        new, st = orig(gen, pstate, feats, *a, **kw)
        if int(new.map.num_cams) == 3:  # drop the first registered camera, report it accepted
            return pstate._replace(prev_feats=feats), st
        return new, st

    mp.setattr(incremental, "register_frame", broken)


def _k1_half_queries(mp):
    from sfm_mvs_tpu_torch.ops import matching_cuda

    orig = matching_cuda.knn_match_cuda

    def broken(desc0, desc1, valid0, valid1, ratio=0.70):
        half = valid0.clone()
        half[1::2] = False  # every other query left out
        return orig(desc0, desc1, half, valid1, ratio=ratio)

    mp.setattr(matching_cuda, "knn_match_cuda", broken)


def _k1_answer_altered(mp):
    from sfm_mvs_tpu_torch.ops import matching_cuda

    orig = matching_cuda.knn_match_cuda

    def broken(desc0, desc1, valid0, valid1, ratio=0.70):
        m = orig(desc0, desc1, valid0, valid1, ratio=ratio)
        i = int(torch.nonzero(m.valid)[0, 0])
        idx1 = m.idx1.clone()
        idx1[i] = (idx1[i] + 1) % desc1.shape[0]
        return m._replace(idx1=idx1)

    mp.setattr(matching_cuda, "knn_match_cuda", broken)


def _pose_altered(mp):
    from sfm_mvs_tpu_torch.models import ba

    orig = ba.bundle_adjust_map

    def broken(state, *a, **kw):
        out, stats = orig(state, *a, **kw)
        poses = out.poses.clone()
        poses[int(out.num_cams) - 1, 0, 3] += 0.3  # the newest camera moved after BA
        return out._replace(poses=poses), stats

    mp.setattr(ba, "bundle_adjust_map", broken)


def _mvs_half_refs(mp):
    from sfm_mvs_tpu_torch.models import mvs

    orig = mvs.densify_map

    def broken(images, state, **kw):
        return orig(images, state, max_refs=int(state.num_cams) // 2, **kw)

    mp.setattr(mvs, "densify_map", broken)


def _sweep_depth_altered(mp):
    from sfm_mvs_tpu_torch.models import mvs

    orig = mvs._plane_sweep_batch

    def broken(*a, **kw):
        dm = orig(*a, **kw)
        return dm._replace(depth=dm.depth * 1.1)

    mp.setattr(mvs, "_plane_sweep_batch", broken)


def _sweep_half_neighbors(mp):
    from sfm_mvs_tpu_torch.models import mvs

    orig = mvs._plane_sweep_batch

    def broken(ref_b, nbr_b, pose_b, nposes_b, *a, **kw):
        m = nbr_b.shape[1] // 2  # half the neighbor views left out of the cost
        return orig(ref_b, nbr_b[:, :m], pose_b, nposes_b[:, :m], *a, **kw)

    mp.setattr(mvs, "_plane_sweep_batch", broken)


def _fusion_tolerance_doubled(mp):
    from sfm_mvs_tpu_torch.models import mvs

    orig = mvs._fuse_batch

    def broken(*a, **kw):
        a = list(a)
        a[10] = a[10] * 2  # rel_tol
        return orig(*a, **kw)

    mp.setattr(mvs, "_fuse_batch", broken)


def _mvs_fusion_unchanged(mp):
    from sfm_mvs_tpu_torch.models import mvs

    orig = mvs._fuse_batch

    def broken(depth_b, conf_b, valid_b, *a, **kw):
        pts, cols, ok, _, _ = orig(depth_b, conf_b, valid_b, *a, **kw)
        return pts, cols, ok, valid_b, depth_b  # pass 1's maps, unfiltered and unfused

    mp.setattr(mvs, "_fuse_batch", broken)


def _cloud_point_altered(mp):
    from sfm_mvs_tpu_torch.models import mvs

    orig = mvs.densify_map

    def broken(*a, **kw):
        pts, cols, dms = orig(*a, **kw)
        pts = pts.copy()
        pts[len(pts) // 2] += 0.05
        return pts, cols, dms

    mp.setattr(mvs, "densify_map", broken)


def _depth_altered(mp):
    from sfm_mvs_tpu_torch.models import mvs

    orig = mvs.densify_map

    def broken(*a, **kw):
        pts, cols, dms = orig(*a, **kw)
        return pts, cols, {r: dm._replace(depth=dm.depth * 1.2) for r, dm in dms.items()}

    mp.setattr(mvs, "densify_map", broken)


FAULTS = [
    ("fountain11-incremental", _ba_state_unchanged, "ba_cost_gap"),
    ("fountain11-incremental", _ba_input_with_its_cost, "ba_descent"),
    ("fountain11-incremental", _triangulation_altered, "tri_gap"),
    ("fountain11-incremental", _register_state_unchanged, "unregistered"),
    ("fountain11-incremental", _k1_half_queries, "k1_gap"),
    ("fountain11-incremental", _k1_answer_altered, "k1_gap"),
    ("fountain11-incremental", _pose_altered, "ba_cost_gap"),
    ("fountain11-dense", _mvs_half_refs, "depth_uncovered"),
    ("fountain11-dense", _sweep_depth_altered, "sweep_mismatch"),
    ("fountain11-dense", _sweep_half_neighbors, "sweep_mismatch"),
    ("fountain11-dense", _fusion_tolerance_doubled, "fuse_mismatch"),
    ("fountain11-dense", _mvs_fusion_unchanged, "cloud_gap"),
    ("fountain11-dense", _cloud_point_altered, "cloud_gap"),
    ("fountain11-dense", _depth_altered, "depth_median"),
]


@pytest.mark.parametrize("cell,fault,check", FAULTS,
                         ids=[f"{c}-{f.__name__.lstrip('_')}" for c, f, _ in FAULTS])
def test_a_broken_step_is_not_correct(monkeypatch, cell, fault, check):
    fault(monkeypatch)
    res = tiny.run_tiny(cell)
    c = res["checks"][check]
    assert not res["correct"]
    assert not c["value"] <= c["limit"], res["checks"]
