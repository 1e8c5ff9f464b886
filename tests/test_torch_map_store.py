"""Map store appends, state conversion, and the framework-neutral copies.

The append functions must reproduce the JAX package's map exactly (integer
ids, masks and copied floats are compared bitwise), including duplicate
point ids in one observation append resolving to the lowest slot.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import J, N, T

from sfm_mvs_tpu.models import map_store as jms
from sfm_mvs_tpu.utils import config as jconfig
from sfm_mvs_tpu.utils import synthetic as jsyn
from sfm_mvs_tpu_torch.models import map_store
from sfm_mvs_tpu_torch.utils import config, convert, synthetic

MCFG = config.MapConfig(max_cameras=4, max_points=64)
JMCFG = jconfig.MapConfig(max_cameras=4, max_points=64)
K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)


def _assert_maps_equal(ours, ref):
    for name, a, b in zip(ref._fields, ours, ref):
        np.testing.assert_array_equal(N(a), N(b), err_msg=name)


def _grow(rng, ms, state, pose, n, conv):
    X = rng.normal(size=(n, 3)).astype(np.float32)
    col = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    valid = rng.random(n) < 0.6
    state, cam = ms.append_camera(state, conv(pose))
    state, pids = ms.append_points(state, conv(X), conv(col), conv(valid))
    uv = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    state = ms.append_observations(state, cam, pids, conv(uv), conv(valid))
    return state, pids


def test_appends_match_jax(rng):
    ours = map_store.init_map(T(K), MCFG)
    ref = jms.init_map(J(K), JMCFG)
    _assert_maps_equal(ours, ref)
    seed = 5
    for step in range(3):  # the third append overflows the point capacity
        pose = np.eye(3, 4, dtype=np.float32) + step
        ours, pids = _grow(np.random.default_rng(seed + step), map_store, ours, pose, 40, T)
        ref, pids_j = _grow(np.random.default_rng(seed + step), jms, ref, pose, 40, J)
        np.testing.assert_array_equal(N(pids), N(pids_j))
        _assert_maps_equal(ours, ref)
    assert int(ours.num_points) == 64
    assert int(map_store.num_observations(ours)) == int(jms.num_observations(ref))


def test_duplicate_observation_ids_lowest_slot_wins(rng):
    ours = map_store.init_map(T(K), MCFG)
    ref = jms.init_map(J(K), JMCFG)
    ours, _ = map_store.append_camera(ours, T(np.eye(3, 4, dtype=np.float32)))
    ref, _ = jms.append_camera(ref, J(np.eye(3, 4, dtype=np.float32)))
    X = rng.normal(size=(8, 3)).astype(np.float32)
    ones = np.ones(8, bool)
    ours, _ = map_store.append_points(ours, T(X), T(X), T(ones))
    ref, _ = jms.append_points(ref, J(X), J(X), J(ones))
    pids = np.array([3, 1, 3, -1, 1, 7, 3, 2, 70], np.int32)  # dupes, -1, out of range
    uv = np.arange(18, dtype=np.float32).reshape(9, 2)
    valid = np.array([0, 1, 1, 1, 1, 1, 1, 1, 1], bool)
    cam = np.int32(0)
    ours = map_store.append_observations(ours, T(cam), T(pids), T(uv), T(valid))
    ref = jms.append_observations(ref, J(cam), J(pids), J(uv), J(valid))
    _assert_maps_equal(ours, ref)
    # point 3: slot 0 is invalid, so slot 2 (the lowest valid one) wins
    np.testing.assert_array_equal(N(ours.obs_uv)[3, 0], uv[2])
    np.testing.assert_array_equal(N(ours.obs_uv)[1, 0], uv[1])


def test_append_indices(rng):
    valid = rng.random(50) < 0.5
    dest, cnt = map_store._append_indices(T(np.int32(10)), T(valid), 30)
    dest_j, cnt_j = jms._append_indices(jnp.int32(10), J(valid), 30)
    np.testing.assert_array_equal(N(dest), N(dest_j))
    assert int(cnt) == int(cnt_j)


def test_convert_round_trip(rng):
    ref = jms.init_map(J(K), JMCFG)
    ref, _ = _grow(rng, jms, ref, np.eye(3, 4, dtype=np.float32), 20, J)
    leaves = type(ref)(*[np.asarray(a) for a in ref])
    state = convert.to_torch(leaves)
    assert isinstance(state, map_store.MapState)
    assert state.num_points.dtype == torch.int32 and state.obs_mask.dtype == torch.bool
    back = convert.to_numpy(state)
    for name, a, b in zip(ref._fields, back, leaves):
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype, name


def test_convert_rejects_foreign_types():
    from collections import namedtuple

    Other = namedtuple("MapState", ["a"])
    with pytest.raises(TypeError):
        convert.to_torch(Other(np.zeros(1)))


def test_config_matches_jax_package():
    for name in ("FrontendConfig", "RansacConfig", "BaConfig", "SweepConfig",
                 "MapConfig", "SfmConfig"):
        ours = getattr(config, name)
        ref = getattr(jconfig, name)
        assert [(f.name, f.type) for f in dataclasses.fields(ours)] == [
            (f.name, f.type) for f in dataclasses.fields(ref)], name
        assert dataclasses.asdict(ours()) == dataclasses.asdict(ref()), name
    np.testing.assert_array_equal(config.SfmConfig().intrinsic_matrix(),
                                  jconfig.SfmConfig().intrinsic_matrix())


def test_staircase_renderer_is_bitwise_identical():
    kw = dict(num_cameras=3, image_size=(96, 64), focal=120.0, arc_degrees=20,
              texture_size=256, seed=3)
    imgs, Rt, Kr = synthetic.render_staircase_sequence(**kw)
    imgs_j, Rt_j, Kr_j = jsyn.render_staircase_sequence(**kw)
    for a, b in zip(imgs, imgs_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(Rt, Rt_j)
    np.testing.assert_array_equal(Kr, Kr_j)


def test_track_vector_duplicate_slots_match_xla_cpu(rng):
    """Duplicate target slots (a one-directional matcher maps two queries to
    one train feature): the port's rule — the highest match slot wins — is
    the order XLA's CPU scatter applies the writes in."""
    import jax

    from sfm_mvs_tpu_torch.models.incremental import _track_vector

    n, M = 64, 200
    slot = rng.integers(0, n + 8, M).astype(np.int32)  # duplicates and out-of-range
    write = rng.random(M) < 0.7
    vals = rng.integers(0, 1000, M).astype(np.int32)

    @jax.jit
    def xla(slot, write, vals):
        dest = jnp.where(write, slot, n)
        return jnp.full((n,), -1, jnp.int32).at[dest].set(vals, mode="drop")

    keep = slot < n  # the port's callers only pass in-range slots
    ours = _track_vector(n, T(slot * keep), T(write & keep), T(vals))
    np.testing.assert_array_equal(N(ours), N(xla(J(slot), J(write & keep), J(vals))))
