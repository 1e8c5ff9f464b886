"""The port's split-phase loop stitching (models/exhaustive.py) against JAX.

The twin of tests/test_stitch.py, on its 6-frame 320x240 staircase
reconstruction (the port's driver, the map carried into the JAX package).
Tolerances. ``ransac_essential_batch``: with B = 1 bitwise equal to
``ransac_essential`` on the same injected samples, with B = 3 equal to
three single calls. ``stitch_candidates_batch`` on the JAX package's
samples: ``ok`` masks identical (a pad row included), track ids equal and
pixels within 1e-5 where ok. ``apply_stitch_batch`` (both directions) and
``inject_reobservations_batch``: obs_mask bitwise, obs_uv within 1e-5,
counts equal. Candidates plus apply reproduce the fused injection, and a
re-apply injects nothing. ``_dedup_scatter_targets`` on hand-made
duplicate cameras and track ids (ties included) equals JAX's.
``covisibility_matrix`` exact; ``retrieve_stitch_pairs`` identical lists.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import J, N, T

from sfm_mvs_tpu.models import exhaustive as jex
from sfm_mvs_tpu.models import map_store as jms
from sfm_mvs_tpu.ops import matching as jmatching
from sfm_mvs_tpu.ops import ransac as jransac
from sfm_mvs_tpu.utils import config as jconfig
from sfm_mvs_tpu_torch.models import exhaustive
from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM
from sfm_mvs_tpu_torch.ops import matching, projection, ransac
from sfm_mvs_tpu_torch.ops.sift import Features
from sfm_mvs_tpu_torch.utils import config, convert
from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence

ITERS = 256


def _cfgs(K):
    def build(c):
        return c.SfmConfig(
            fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
            downscale=1,
            frontend=c.FrontendConfig(max_features=1024, num_octaves=3, upsample_input=True,
                                      contrast_threshold=0.015, lowe_ratio=0.75),
            ransac=c.RansacConfig(essential_iters=ITERS),
            map=c.MapConfig(max_cameras=8, max_points=16384))

    return build(config), build(jconfig)


@pytest.fixture(scope="module")
def recon():
    imgs, _, K = render_staircase_sequence(num_cameras=6, arc_degrees=30, image_size=(320, 240))
    cfg, jcfg = _cfgs(K)
    sfm = IncrementalSfM(cfg, device="cpu")
    state = sfm.run(imgs)
    jstate = jms.MapState(*[J(a) for a in convert.to_numpy(state)])
    return dict(sfm=sfm, state=state, jstate=jstate, cfg=cfg, jcfg=jcfg)


def _batch(sfm, pairs, pad=0):
    """The port's and JAX's stacked inputs; `pad` extra rows repeat the
    first pair with pair_valid False."""
    rows = pairs + pairs[:1] * pad
    feats, tracks = sfm._cam_feats, sfm._cam_tracks

    def stack(fs):
        return Features(*[torch.stack(col) for col in zip(*fs)])

    fi = stack([feats[i] for i, _ in rows])
    fj = stack([feats[j] for _, j in rows])
    ti = torch.stack([tracks[i] for i, _ in rows])
    tj = torch.stack([tracks[j] for _, j in rows])
    cam_is = torch.tensor([i for i, _ in rows], dtype=torch.int32)
    cam_js = torch.tensor([j for _, j in rows], dtype=torch.int32)
    valid = torch.tensor([True] * len(pairs) + [False] * pad)
    port = (cam_is, cam_js, fi, fj, ti, tj, valid)
    jf = [jex.Features(*[J(a) for a in convert.to_numpy(f)]) for f in (fi, fj)]
    jax_in = (J(cam_is), J(cam_js), jf[0], jf[1], J(ti), J(tj), J(valid))
    return port, jax_in


def _jax_samples(keys, jfi, jfj, jcfg):
    """(B, iters, 8): the draw each pair's ransac_essential makes inside JAX's
    vmapped stitch (its key split, then the 8-point stream)."""
    out = []
    for b in range(jfi.valid.shape[0]):
        m = jmatching.knn_match(jfi.desc[b], jfj.desc[b], jfi.valid[b], jfj.valid[b],
                                ratio=jcfg.frontend.lowe_ratio)
        k1, _ = jax.random.split(keys[b])
        out.append(np.asarray(jransac._sample_indices(k1, jcfg.ransac.essential_iters, 8,
                                                      jnp.sum(m.valid), m.valid.shape[0])))
    return torch.as_tensor(np.stack(out))


def _pair_norms(sfm, pairs, cfg):
    K = torch.as_tensor(cfg.intrinsic_matrix())
    n0, n1, mv = [], [], []
    for i, j in pairs:
        fi, fj = sfm._cam_feats[i], sfm._cam_feats[j]
        m = matching.knn_match(fi.desc, fj.desc, fi.valid, fj.valid, ratio=0.75)
        u0, u1, v = matching.gather_match_points(fi.xy, fj.xy, m)
        n0.append(projection.normalize_points(u0, K))
        n1.append(projection.normalize_points(u1, K))
        mv.append(v)
    return torch.stack(n0), torch.stack(n1), torch.stack(mv), 0.5 * (K[0, 0] + K[1, 1])


@pytest.mark.parametrize("B", [1, 3])
def test_ransac_essential_batch_equals_single_calls(recon, B):
    pairs = [(0, 3), (1, 4), (2, 5)][:B]
    n0, n1, mv, focal = _pair_norms(recon["sfm"], pairs, recon["cfg"])
    rng = np.random.default_rng(B)
    idx = torch.stack([torch.as_tensor(rng.integers(0, int(v.sum()), (ITERS, 8))) for v in mv])
    bat = ransac.ransac_essential_batch(None, n0, n1, mv, focal, iters=ITERS, sample_idx=idx)
    assert bat.model.shape == (B, 3, 3) and bat.inliers.shape == mv.shape
    for b in range(B):
        one = ransac.ransac_essential(None, n0[b], n1[b], mv[b], focal, iters=ITERS,
                                      sample_idx=idx[b])
        assert torch.equal(bat.model[b], one.model)
        assert torch.equal(bat.inliers[b], one.inliers)
        assert int(bat.num_inliers[b]) == int(one.num_inliers) > 30
    with pytest.raises(ValueError, match="8pt"):
        ransac.ransac_essential_batch(None, n0, n1, mv, focal, solver="5pt")


def test_stitch_candidates_match_jax(recon):
    pairs = [(0, 3), (1, 4), (2, 5)]
    port, jin = _batch(recon["sfm"], pairs, pad=1)
    keys = jax.random.split(jax.random.PRNGKey(11), len(pairs) + 1)
    ref = jex.stitch_candidates_batch(recon["jstate"], *jin, recon["jcfg"], keys)
    idx = _jax_samples(keys, jin[2], jin[3], recon["jcfg"])
    cand = exhaustive.stitch_candidates_batch(recon["state"], *port, recon["cfg"], sample_idx=idx)
    ok = N(cand.ok)
    np.testing.assert_array_equal(ok, N(ref.ok))
    assert ok[:3].sum(1).min() > 0 and not ok[3].any()
    for f in ("tids_a", "tids_b"):
        np.testing.assert_array_equal(N(getattr(cand, f))[ok], N(getattr(ref, f))[ok])
    for f in ("uv_a", "uv_b"):
        np.testing.assert_allclose(N(getattr(cand, f))[ok], N(getattr(ref, f))[ok], atol=1e-5)
    np.testing.assert_array_equal(N(cand.cam_a), N(ref.cam_a))
    np.testing.assert_array_equal(N(cand.cam_b), N(ref.cam_b))


@pytest.fixture(scope="module")
def candidates(recon):
    """Candidates of pairs (0, 4), (1, 5) in both packages, on JAX's samples."""
    pairs = [(0, 4), (1, 5)]
    port, jin = _batch(recon["sfm"], pairs)
    keys = jax.random.split(jax.random.PRNGKey(5), len(pairs))
    ref = jex.stitch_candidates_batch(recon["jstate"], *jin, recon["jcfg"], keys)
    idx = _jax_samples(keys, jin[2], jin[3], recon["jcfg"])
    cand = exhaustive.stitch_candidates_batch(recon["state"], *port, recon["cfg"], sample_idx=idx)
    return cand, ref


def test_apply_stitch_batch_matches_jax(recon, candidates):
    cand, ref = candidates
    gate = recon["cfg"].map.stitch_gate_px
    s, js = recon["state"], recon["jstate"]
    for d in ("a", "b"):
        args = [getattr(cand, f"{k}_{d}") for k in ("cam", "tids", "uv")] + [cand.ok]
        jargs = [getattr(ref, f"{k}_{d}") for k in ("cam", "tids", "uv")] + [ref.ok]
        s, n = exhaustive.apply_stitch_batch(s, *args, gate)
        js, jn = jex.apply_stitch_batch(js, *jargs, jnp.asarray(gate))
        np.testing.assert_array_equal(N(n), N(jn))
        assert int(n.sum()) > 0
    np.testing.assert_array_equal(N(s.obs_mask), N(js.obs_mask))
    np.testing.assert_allclose(N(s.obs_uv), N(js.obs_uv), atol=1e-5)


@pytest.mark.parametrize("verify", [False, True])
def test_inject_reobservations_batch_matches_jax(recon, verify):
    pairs = [(0, 3), (1, 4), (5, 2)]
    port, jin = _batch(recon["sfm"], pairs, pad=1)
    keys = jax.random.split(jax.random.PRNGKey(3), len(pairs) + 1)
    kw = dict(max_err_px=32.0, epipolar_verify=True) if verify else {}
    jcam_js, jfi, jfj, jti, jvalid = jin[1], jin[2], jin[3], jin[4], jin[6]
    ref, jn = jex.inject_reobservations_batch(recon["jstate"], jcam_js, jfi, jfj, jti, jvalid,
                                              recon["jcfg"], keys, **kw)
    idx = _jax_samples(keys, jfi, jfj, recon["jcfg"]) if verify else None
    cam_js, fi, fj, ti, valid = port[1], port[2], port[3], port[4], port[6]
    out, n = exhaustive.inject_reobservations_batch(recon["state"], cam_js, fi, fj, ti, valid,
                                                    recon["cfg"], sample_idx=idx, **kw)
    np.testing.assert_array_equal(N(n), N(jn))
    assert int(n.sum()) > 0 and int(n[3]) == 0
    np.testing.assert_array_equal(N(out.obs_mask), N(ref.obs_mask))
    np.testing.assert_allclose(N(out.obs_uv), N(ref.obs_uv), atol=1e-5)


def test_candidates_plus_apply_equal_fused_injection(recon):
    pairs = [(0, 3), (1, 4), (2, 5)]
    port, _ = _batch(recon["sfm"], pairs)
    gen = torch.Generator()
    gen.manual_seed(11)
    cam_is, cam_js, fi, fj, ti, tj, valid = port
    idx = torch.as_tensor(np.random.default_rng(2).integers(0, 150, (3, ITERS, 8)))
    ref, n_ref = exhaustive.inject_reobservations_batch(
        recon["state"], cam_js, fi, fj, ti, valid, recon["cfg"], sample_idx=idx,
        max_err_px=32.0, epipolar_verify=True)
    cand = exhaustive.stitch_candidates_batch(recon["state"], *port, recon["cfg"], sample_idx=idx)
    out, n = exhaustive.apply_stitch_batch(recon["state"], cand.cam_a, cand.tids_a, cand.uv_a,
                                           cand.ok, 32.0)
    assert int(n.sum()) == int(n_ref.sum()) > 0
    assert torch.equal(out.obs_mask, ref.obs_mask) and torch.equal(out.obs_uv, ref.obs_uv)
    with pytest.raises(ValueError, match="generator"):
        exhaustive.inject_reobservations_batch(recon["state"], cam_js, fi, fj, ti, valid,
                                               recon["cfg"], epipolar_verify=True)
    # a generator serves in place of injected samples
    exhaustive.stitch_candidates_batch(recon["state"], *port, recon["cfg"], gen=gen)


def test_reapply_is_idempotent(recon, candidates):
    cand, _ = candidates
    gate = recon["cfg"].map.stitch_gate_px
    s = recon["state"]
    counts = []
    for _ in range(2):
        for d in ("a", "b"):
            s, n = exhaustive.apply_stitch_batch(s, getattr(cand, f"cam_{d}"),
                                                 getattr(cand, f"tids_{d}"),
                                                 getattr(cand, f"uv_{d}"), cand.ok, gate)
            counts.append(int(n.sum()))
        if len(counts) == 2:
            first = s.obs_mask.clone()
    assert counts[0] > 0 and counts[1] > 0 and counts[2:] == [0, 0]
    assert torch.equal(s.obs_mask, first)
    assert not torch.equal(s.obs_mask, recon["state"].obs_mask)


DEDUP_CASES = {
    # rows 0 and 2 share camera 1 (row 2 masked); row 1 has no valid entry
    # and claims nothing; row 3 repeats track 4 with errors 2.0, 1.0, 1.0
    # (the first 1.0 wins), and its masked slot 3 leaves track 5 to slot 4.
    "cams_and_ties": dict(
        ok=[[1, 1, 0, 1, 1], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1], [1, 1, 1, 0, 1]],
        tids=[[0, 1, 2, 3, 3], [4, 5, 6, 7, 8], [0, 9, 9, 1, 1], [4, 4, 4, 5, 5]],
        err=[[0.5, 0.5, 0.5, 3.0, 2.0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1],
             [2.0, 1.0, 1.0, 0.1, 0.2]],
        cam=[1, 1, 1, 2]),
    # an exact error tie within a row keeps the lowest match index; a camera
    # out of range is clamped to the last camera
    "exact_tie": dict(
        ok=[[1, 1, 1, 1], [1, 0, 1, 1]],
        tids=[[7, 7, 7, 2], [3, 3, 3, 3]],
        err=[[0.25, 0.25, 0.25, 9.0], [4.0, 1.0, 4.0, 4.0]],
        cam=[0, 9]),
    # every row targets one camera: only row 0 survives
    "one_camera": dict(
        ok=[[0, 1, 1], [1, 1, 1], [1, 0, 1]],
        tids=[[1, 2, 2], [1, 2, 3], [4, 5, 6]],
        err=[[0, 3.0, 3.0], [0, 0, 0], [0, 0, 0]],
        cam=[2, 2, 2]),
}


@pytest.mark.parametrize("case", sorted(DEDUP_CASES))
def test_dedup_scatter_targets_matches_jax(case):
    c = DEDUP_CASES[case]
    ok = np.asarray(c["ok"], bool)
    tids = np.asarray(c["tids"], np.int32)
    err = np.asarray(c["err"], np.float32)
    cam = np.asarray(c["cam"], np.int32)
    P, C = 16, 4
    ref = N(jex._dedup_scatter_targets(J(ok), J(tids), J(err), J(cam), P, C))
    out = N(exhaustive._dedup_scatter_targets(T(ok), T(tids), T(err), T(cam), P, C))
    np.testing.assert_array_equal(out, ref)
    assert (out <= ok).all()
    if case == "cams_and_ties":
        np.testing.assert_array_equal(out, [[1, 1, 0, 0, 1], [0] * 5, [0] * 5, [0, 1, 0, 0, 1]])


def test_covisibility_and_retrieval_match_jax(recon):
    s, js = recon["state"], recon["jstate"]
    for size in (None, (320, 240), (200, 240)):
        cnt = exhaustive.covisibility_matrix(s, image_size=size)
        ref = jex.covisibility_matrix(js, image_size=size)
        assert cnt.dtype == torch.int32
        np.testing.assert_array_equal(N(cnt), N(ref))
    cnt = N(exhaustive.covisibility_matrix(s, image_size=(320, 240)))
    n = int(s.cam_valid.sum())
    assert all(cnt[i, i] >= cnt[i].max() - 1 for i in range(n))
    for kw in (dict(min_gap=3, min_covis=20), dict(min_gap=1, min_covis=1),
               dict(min_gap=2, min_covis=48, octaves=((1, 2), (2, 4), (4, 1 << 30)))):
        pairs = exhaustive.retrieve_stitch_pairs(cnt, n, **kw)
        assert pairs == jex.retrieve_stitch_pairs(cnt, n, **kw)
        assert all(j - i >= kw["min_gap"] and cnt[i, j] >= kw["min_covis"] for i, j in pairs)
    assert exhaustive.retrieve_stitch_pairs(cnt, n, min_gap=3, min_covis=20)
