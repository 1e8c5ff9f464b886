"""The port's plain 2-NN matcher against the JAX matcher and its Pallas kernel.

The port's ``knn_match`` is the plain version the CUDA kernel is checked
against on the card (chip_smoke.py); here it is held to the JAX package's
``knn_match`` and to ``knn_match_pallas`` in interpret mode, on the cases of
tests/test_matching_pallas.py plus the mutual check. On these
well-separated random descriptors ``valid`` and ``idx1`` must be identical
(the distance products are summed in another order, so distances agree to
rounding only).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import J, N, T

from sfm_mvs_tpu.ops import matching as jm
from sfm_mvs_tpu.ops.matching_pallas import knn_match_pallas
from sfm_mvs_tpu_torch.ops import matching, matching_cuda
from sfm_mvs_tpu_torch.utils import profiling
from sfm_mvs_tpu_torch.utils.config import FrontendConfig


@contextlib.contextmanager
def _tracer_on():
    """The port's tracer on and empty inside, off and empty after."""
    profiling.reset()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.reset()


def _descs(rng, n, d=128):
    x = rng.random((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _case(rng, name):
    if name == "300x300":
        d0 = _descs(rng, 300)
        d1 = d0[rng.permutation(300)] + 0.01 * rng.standard_normal((300, 128)).astype(np.float32)
        d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
        return d0, d1, np.ones(300, bool), np.ones(300, bool), 0.7
    if name == "100x600":  # > 1 train tile and a padded remainder
        d0 = _descs(rng, 100)
        d1 = np.vstack([_descs(rng, 500), d0[:100]]).astype(np.float32)
        return d0, d1, np.ones(100, bool), np.ones(600, bool), 0.8
    d0 = _descs(rng, 64)  # invalid masks
    d1 = np.vstack([d0[:32], d0[:32]]).astype(np.float32)
    return d0, d1, np.arange(64) < 40, np.arange(64) < 32, 0.7


@pytest.mark.parametrize("name", ["300x300", "100x600", "invalid-masks"])
@pytest.mark.parametrize("mutual", [False, True])
def test_plain_matches_jax(rng, name, mutual):
    d0, d1, v0, v1, ratio = _case(rng, name)
    ours = matching.knn_match(T(d0), T(d1), T(v0), T(v1), ratio=ratio, mutual=mutual)
    ref = jm.knn_match(J(d0), J(d1), J(v0), J(v1), ratio=ratio, mutual=mutual)
    np.testing.assert_array_equal(N(ours.valid), N(ref.valid))
    np.testing.assert_array_equal(N(ours.idx1), N(ref.idx1))
    np.testing.assert_array_equal(N(ours.idx0), N(ref.idx0))
    assert ours.idx1.dtype == torch.int32 and ours.valid.any()
    if not mutual:
        pal = knn_match_pallas(J(d0), J(d1), J(v0), J(v1), ratio=ratio, interpret=True)
        np.testing.assert_array_equal(N(ours.valid), N(pal.valid))
        rv = N(ours.valid)
        np.testing.assert_array_equal(N(ours.idx1)[rv], N(pal.idx1)[rv])


def test_distances_and_top2(rng):
    d0, d1, _, v1, _ = _case(rng, "100x600")
    v1 = v1 & (rng.random(600) < 0.9)
    D = matching.distance_matrix(T(d0), T(d1), T(v1))
    Dj = jm.distance_matrix(J(d0), J(d1), J(v1))
    np.testing.assert_allclose(N(D), N(Dj), rtol=1e-5, atol=1e-5)
    a, b, c = matching.top2(D)
    aj, bj, cj = jm.top2(J(N(D)))  # same matrix in: identical reduction
    np.testing.assert_array_equal(N(a), N(aj))
    np.testing.assert_array_equal(N(b), N(bj))
    np.testing.assert_array_equal(N(c), N(cj))


def test_gather_match_points(rng):
    kp0 = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    kp1 = rng.uniform(0, 100, (60, 2)).astype(np.float32)
    idx1 = rng.integers(0, 60, 50).astype(np.int32)
    valid = rng.random(50) < 0.5
    m = matching.Matches(T(np.arange(50, dtype=np.int32)), T(idx1), T(valid))
    mj = jm.Matches(jnp.arange(50, dtype=jnp.int32), J(idx1), J(valid))
    for a, b in zip(matching.gather_match_points(T(kp0), T(kp1), m),
                    jm.gather_match_points(J(kp0), J(kp1), mj)):
        np.testing.assert_array_equal(N(a), N(b))


def test_cuda_module_on_cpu_tensors(rng):
    """matching_cuda imports with no nvcc and no GPU; on CPU tensors the
    wrapper returns the plain result and launches nothing (the tracer, on,
    records no ``k1`` span and no ``k1.*`` counter)."""
    d0, d1, v0, v1, ratio = _case(rng, "300x300")
    with _tracer_on():
        ours = matching_cuda.knn_match_cuda(T(d0), T(d1), T(v0), T(v1), ratio=ratio)
        traced = profiling.export()
    plain = matching.knn_match(T(d0), T(d1), T(v0), T(v1), ratio=ratio)
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)
    assert traced["spans"] == [] and traced["counters"] == {}
    with pytest.raises(ValueError, match="CUDA tensor"):
        matching_cuda.knn2_raw(T(d0), T(d1), T(v1))


@pytest.mark.parametrize("use_kernel,mutual", [(True, False), (False, False), (True, True)])
def test_match_with_config_routes_like_jax(rng, use_kernel, mutual):
    d0, d1, v0, v1, _ = _case(rng, "300x300")
    cfg = FrontendConfig(use_pallas_matcher=use_kernel, mutual_check=mutual, lowe_ratio=0.8)
    ours = matching.match_with_config(T(d0), T(d1), T(v0), T(v1), cfg)
    ref = jm.match_with_config(J(d0), J(d1), J(v0), J(v1), cfg)
    np.testing.assert_array_equal(N(ours.valid), N(ref.valid))
    np.testing.assert_array_equal(N(ours.idx1), N(ref.idx1))


@pytest.mark.parametrize("n1", [1, 100, 4096, 4097])
@pytest.mark.parametrize("n0", [1, 300, 4096])
def test_plan_splits_covers_every_column_tile_once(n0, n1):
    """The CUDA kernel's train splits: each 128-column tile in exactly one
    split, no split empty, on cards of several sizes."""
    col_tiles = -(-n1 // matching_cuda.TILE)
    for sms in (1, 66, 132):
        splits, per = matching_cuda.plan_splits(n0, n1, sms)
        covered = [t for s in range(splits) for t in range(s * per, min(col_tiles, (s + 1) * per))]
        assert sorted(covered) == list(range(col_tiles))
        assert all(s * per < col_tiles for s in range(splits))
    if (n0, n1) == (4096, 4096):  # the main path: 32 row tiles x 8 splits, one wave
        assert matching_cuda.plan_splits(n0, n1, 132) == (8, 4)


def test_ratio_test_rounds_ratio_squared_to_float32(rng):
    """The plain ratio test decides d1 < float32(ratio * ratio) * d2 with one
    float32 product, on values at and one ulp either side of that bound and
    of the bound in float64. The CUDA merge kernel copies this rounding."""
    d2 = rng.uniform(1e-3, 4.0, 400).astype(np.float32)
    n_double_differs = 0
    for ratio in [0.6, 0.7, 0.75, 0.8, 0.9, *rng.uniform(0.5, 0.95, 20)]:
        r2 = np.float32(ratio * ratio)
        edge32 = r2 * d2  # float32 product
        edge64 = (ratio * ratio * d2.astype(np.float64)).astype(np.float32)
        cands = [e2 for e in (edge32, edge64)
                 for e2 in (e, np.nextafter(e, np.float32(0)), np.nextafter(e, np.float32(np.inf)))]
        d1 = np.concatenate(cands)
        dd2 = np.tile(d2, len(cands))
        valid0 = np.ones(len(d1), bool)
        valid0[::7] = False
        ok = matching.ratio_test(T(valid0), T(d1), T(dd2), ratio)
        want = valid0 & (d1 < r2 * dd2) & (d1 < np.float32(matching.BIG))
        np.testing.assert_array_equal(N(ok), want)
        n_double_differs += int(((d1 < ratio * ratio * dd2.astype(np.float64)) != (d1 < r2 * dd2)).sum())
    assert n_double_differs > 0  # the cases tell float32 rounding from float64


def _batch(rng, B=4, n0=300, n1=300):
    """B pairs of test_plain_matches_jax's "300x300" kind, with masks."""
    cases = []
    for _ in range(B):
        d0 = _descs(rng, n0)
        d1 = d0[rng.permutation(n0)[:n1]] + 0.01 * rng.standard_normal((n1, 128)).astype(np.float32)
        d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
        cases.append((d0, d1, rng.random(n0) > 0.1, rng.random(n1) > 0.1))
    return [np.stack(col) for col in zip(*cases)]


@pytest.mark.parametrize("mutual", [False, True])
def test_plain_batch_equals_single_calls_and_jax(rng, mutual):
    """knn_match over a leading batch axis: each pair's row equals its own
    call, and the JAX package's vmapped frontend.match_batch; the port's
    frontend.match_batch (the batched kernel's wrapper on CPU tensors
    without the mutual check) and match_with_config on a stack agree."""
    from sfm_mvs_tpu.parallel import frontend as jfrontend
    from sfm_mvs_tpu_torch.parallel import frontend

    d0, d1, v0, v1 = _batch(rng)
    ours = matching.knn_match(T(d0), T(d1), T(v0), T(v1), ratio=0.8, mutual=mutual)
    assert ours.idx1.shape == (4, 300) and ours.valid.any()
    for b in range(4):
        one = matching.knn_match(T(d0[b]), T(d1[b]), T(v0[b]), T(v1[b]), ratio=0.8,
                                 mutual=mutual)
        for x, y in zip(ours, one):
            np.testing.assert_array_equal(N(x[b]), N(y))
    ref = jfrontend.match_batch(J(d0), J(d1), J(v0), J(v1), ratio=0.8, mutual=mutual)
    cfg = FrontendConfig(mutual_check=mutual, lowe_ratio=0.8)
    for other in (frontend.match_batch(T(d0), T(d1), T(v0), T(v1), 0.8, mutual),
                  matching.match_with_config(T(d0), T(d1), T(v0), T(v1), cfg), ref):
        for x, y in zip(ours, other):
            np.testing.assert_array_equal(N(x), N(y))


def test_cuda_batch_wrapper_on_cpu_tensors(rng):
    """knn_match_cuda_batch returns the plain batched result on CPU tensors
    and counts nothing; the raw launch refuses CPU tensors."""
    d0, d1, v0, v1 = _batch(rng, B=3)
    with _tracer_on():
        ours = matching_cuda.knn_match_cuda_batch(T(d0), T(d1), T(v0), T(v1), ratio=0.75)
        traced = profiling.export()
    plain = matching.knn_match(T(d0), T(d1), T(v0), T(v1), ratio=0.75)
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)
    assert traced["spans"] == [] and traced["counters"] == {}
    with pytest.raises(ValueError, match="CUDA tensor"):
        matching_cuda.knn2_raw(T(d0), T(d1), T(v1))


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_plan_splits_with_a_batch(batch):
    """With B pairs in the grid every column tile is still in exactly one
    split; at the main path's 4096 x 4096, 8 pairs fill the card with one
    split (8 x 32 row tiles = 256 blocks for 264 slots) where one pair
    takes 8."""
    for n0, n1 in ((4096, 4096), (2048, 2048), (300, 4097)):
        col_tiles = -(-n1 // matching_cuda.TILE)
        splits, per = matching_cuda.plan_splits(n0, n1, 132, batch)
        covered = [t for s in range(splits) for t in range(s * per, min(col_tiles, (s + 1) * per))]
        assert sorted(covered) == list(range(col_tiles))
        assert all(s * per < col_tiles for s in range(splits))
    # 32 pairs take 32 one-tile splits: 125 tile-steps per slot against 128
    # for 4 waves of one split.
    want = {1: (8, 4), 8: (1, 32), 32: (32, 1)}[batch]
    assert matching_cuda.plan_splits(4096, 4096, 132, batch) == want


@pytest.mark.parametrize("use_kernel", [True, False])
def test_match_batch_pad_rows(rng, use_kernel):
    """exhaustive._match_batch: live rows equal the pair's own match; pad
    rows (pair_valid False) come back all invalid with idx1 0."""
    from sfm_mvs_tpu_torch.models import exhaustive
    from sfm_mvs_tpu_torch.ops.sift import Features
    from sfm_mvs_tpu_torch.utils.config import SfmConfig

    d0, d1, v0, v1 = _batch(rng)
    xy = torch.zeros(4, 300, 2)
    z = torch.zeros(4, 300)
    fi = Features(xy, z, z, z, T(d0), T(v0))
    fj = Features(xy, z, z, z, T(d1), T(v1))
    cfg = SfmConfig(frontend=FrontendConfig(use_pallas_matcher=use_kernel, lowe_ratio=0.8))
    live = torch.tensor([True, False, True, False])
    m = exhaustive._match_batch(fi, fj, live, cfg)
    for b in range(4):
        if live[b]:
            one = exhaustive._match(Features(*[f[b] for f in fi]), Features(*[f[b] for f in fj]),
                                    cfg)
            for x, y in zip(m, one):
                assert torch.equal(x[b], y)
            assert m.valid[b].any()
        else:
            assert not m.valid[b].any() and not m.idx1[b].any()
            np.testing.assert_array_equal(N(m.idx0[b]), np.arange(300))
