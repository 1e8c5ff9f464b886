"""The port's sharded map queries at 2 gloo ranks against dense forms and
the JAX package (parallel/sharded_map.py).

One 2-rank job (tests/_torch_parallel_worker.py) blocks the point table
with ``mesh.shard_map_state`` / ``shard_batch`` and runs both queries on
tests/test_sharded_map.py's inputs. Lookups are exact: one rank adds the
point, the others zeros. The nearest query's distances agree to rel 1e-5
with the dense form on one process (they are computed per element in the
same order, so they are in fact equal), and its depths are equal wherever
the dense argmin is unique (a tie may resolve to the other block's point).
Against the JAX package, whose cross term is an XLA dot, the distances
agree to 4 float32 ulps of |q|^2 + |m|^2, the terms the expansion cancels
(~7e5 px^2 here, so ~0.3 px^2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parallel_worker import Ranks
from _torch_parity import N, T

from sfm_mvs_tpu.parallel import mesh as jmeshlib
from sfm_mvs_tpu.parallel import sharded_map as jsharded_map
from sfm_mvs_tpu.utils.synthetic import make_scene
from sfm_mvs_tpu_torch.models import map_store
from sfm_mvs_tpu_torch.ops import projection
from sfm_mvs_tpu_torch.parallel import sharded_map
from sfm_mvs_tpu_torch.utils.config import MapConfig

P = 1024


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    rng = np.random.default_rng(0)
    state = map_store.init_map(torch.eye(3), MapConfig(max_cameras=4, max_points=P))
    state = state._replace(points=T(rng.normal(size=(P, 3)).astype(np.float32)),
                           point_valid=T(rng.random(P) > 0.3))
    tids = np.concatenate([rng.integers(0, P, 120), [-1, -1, P - 1, 0, P, P + 7]]).astype(np.int32)
    scene = make_scene(num_points=512, num_cameras=2)
    inp = dict(state=[N(a) for a in state], tids=tids, points=scene.points.astype(np.float32),
               valid=rng.random(512) > 0.2, pose=scene.Rt[1].astype(np.float32),
               K=scene.K.astype(np.float32),
               uv_q=rng.uniform(0, 600, size=(64, 2)).astype(np.float32))
    ranks = Ranks("sharded_map", inp, str(tmp_path_factory.mktemp("ranks")))
    return ranks.results(), state, inp


def test_shard_map_state_blocks(job):
    """Each rank holds rows [r P/2, (r + 1) P/2) of the point arrays and the
    whole camera state."""
    ranks, state, _ = job
    for r in ranks:
        blk, sl = r["block"], slice(r["rank"] * P // 2, (r["rank"] + 1) * P // 2)
        for f in ("points", "colors", "point_valid", "obs_uv", "obs_mask"):
            np.testing.assert_array_equal(getattr(blk, f), N(getattr(state, f))[sl])
        for f in ("K", "poses", "cam_valid", "num_cams", "num_points"):
            np.testing.assert_array_equal(getattr(blk, f), N(getattr(state, f)))


def test_lookup_points_sharded_exact(job):
    """points[tids] and its validity, exactly, on both ranks; and the JAX
    package's sharded lookup on the 8-device mesh gives the same."""
    ranks, state, inp = job
    tids = inp["tids"]
    inside = (tids >= 0) & (tids < P)
    safe = np.clip(tids, 0, P - 1)
    exp_X = np.where(inside[:, None], N(state.points)[safe], 0.0)
    exp_ok = inside & N(state.point_valid)[safe]
    for r in ranks:
        X, ok = r["lookup"]
        np.testing.assert_array_equal(X, exp_X)
        np.testing.assert_array_equal(ok, exp_ok)
    jX, jok = jsharded_map.lookup_points_sharded(
        jnp.asarray(N(state.points)), jnp.asarray(N(state.point_valid)), jnp.asarray(tids),
        jmeshlib.make_mesh((8,), ("data",)))
    np.testing.assert_array_equal(ranks[0]["lookup"][0], N(jX))
    np.testing.assert_array_equal(ranks[0]["lookup"][1], N(jok))


def _dense(inp):
    """(d2 (M, P) with invalid points at inf, depth (P,), |q|^2 + |m|^2 (M, P))."""
    uv_map, depth = projection.project_depth(T(inp["points"]), T(inp["pose"]), T(inp["K"]))
    ok = T(inp["valid"]) & (depth > 0)
    uv_q = T(inp["uv_q"])
    d2 = sharded_map.squared_distances(uv_q, uv_map)
    terms = (uv_q * uv_q).sum(1)[:, None] + (uv_map * uv_map).sum(1)[None, :]
    return (N(torch.where(ok[None, :], d2, torch.full_like(d2, float("inf")))), N(depth),
            N(terms))


def test_nearest_projected_sharded(job):
    """Per-query nearest projected point: d2 rel 1e-5 of the dense minimum,
    depth equal where the dense argmin is unique, the same bits on both
    ranks, and the JAX package's sharded query within 4 ulps of the
    cancelled terms (depths equal to 1e-5 where the argmin is unique)."""
    ranks, _, inp = job
    d2, depth, terms = _dense(inp)
    dmin = d2.min(1)
    unique = (d2 == dmin[:, None]).sum(1) == 1
    assert unique.mean() > 0.9
    for r in ranks:
        d2_s, z_s = r["nearest"]
        np.testing.assert_allclose(d2_s, dmin, rtol=1e-5)
        np.testing.assert_array_equal(z_s[unique], depth[d2.argmin(1)][unique])
    np.testing.assert_array_equal(ranks[0]["nearest"][0], ranks[1]["nearest"][0])
    np.testing.assert_array_equal(ranks[0]["nearest"][1], ranks[1]["nearest"][1])
    jd2, jz = jsharded_map.nearest_projected_sharded(
        *[jnp.asarray(inp[k]) for k in ("points", "valid", "pose", "K", "uv_q")],
        jmeshlib.make_mesh((8,), ("data",)))
    ulps = 4 * np.finfo(np.float32).eps * terms[np.arange(len(dmin)), d2.argmin(1)]
    assert (np.abs(ranks[0]["nearest"][0] - N(jd2)) <= ulps).all()
    np.testing.assert_allclose(ranks[0]["nearest"][1][unique], N(jz)[unique], rtol=1e-5,
                               atol=1e-5)
