"""The port's plain 2-NN matcher against the JAX matcher and its Pallas kernel.

The port's ``knn_match`` is the plain version the CUDA kernel is checked
against on the card (chip_smoke.py); here it is held to the JAX package's
``knn_match`` and to ``knn_match_pallas`` in interpret mode, on the cases of
tests/test_matching_pallas.py plus the mutual check. On these
well-separated random descriptors ``valid`` and ``idx1`` must be identical
(the distance products are summed in another order, so distances agree to
rounding only).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import J, N, T

from sfm_mvs_tpu.ops import matching as jm
from sfm_mvs_tpu.ops.matching_pallas import knn_match_pallas
from sfm_mvs_tpu_torch.ops import matching, matching_cuda
from sfm_mvs_tpu_torch.utils.config import FrontendConfig


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
    wrapper returns the plain result and launches nothing."""
    d0, d1, v0, v1, ratio = _case(rng, "300x300")
    matching_cuda.reset_launches()
    ours = matching_cuda.knn_match_cuda(T(d0), T(d1), T(v0), T(v1), ratio=ratio)
    plain = matching.knn_match(T(d0), T(d1), T(v0), T(v1), ratio=ratio)
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)
    assert matching_cuda.launches == 0
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
