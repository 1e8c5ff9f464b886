"""Host IO against the JAX package: PLY and pose.csv export (utils/io.py),
image decode and the pyramid downscale (native.py, ops/pyramid.py), and
the metrics log (utils/metrics.py).

Exported files must be byte-identical to the JAX package's for the same
map (carried across with utils/convert.py), on both of its write paths
(the native writer, where it builds, and the numpy fallback). Decoded
images and pyramid levels must be equal bitwise: both packages run the
same C++ source or the same PIL decode, and the 5-tap blur rounds the same
way (to 1e-6 where the port's plain PyTorch pyr_down stands in for
JAX's).
"""

import json

import numpy as np
import pytest
from PIL import Image

from _torch_parity import J, N, T, ba_map, jax_and_port

from sfm_mvs_tpu import native as jnative
from sfm_mvs_tpu.ops import pyramid as jpyramid
from sfm_mvs_tpu.utils import io as jio
from sfm_mvs_tpu.utils import metrics as jmetrics
from sfm_mvs_tpu_torch import native
from sfm_mvs_tpu_torch.ops import pyramid
from sfm_mvs_tpu_torch.utils import io, metrics


@pytest.fixture(params=["native", "plain"])
def write_path(request, monkeypatch):
    """Both packages on the native writer (where it builds), or both on the
    numpy fallback (the native library marked unavailable).

    Both loaders cache a failed build or dlopen. Under pytest-xdist,
    tests/test_native.py asks for the library at collection in every worker
    at once, and each of those `make`s links into the one output path, so a
    worker may cache a failure that the finished build would not give. A
    first False is therefore asked once more, with the caches cleared, at
    test time, when those builds have ended."""
    if request.param == "native":
        if not (native.available() and jnative.available()):
            native.LIB._error = None
            jnative._lib = None
            if not (native.available() and jnative.available()):
                pytest.skip("the native library does not build here (libjpeg/libpng headers)")
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_lib", False)
    return request.param


@pytest.fixture(scope="module")
def maps():
    """tests/test_ba.py's map with random BGR colors and holes: (JAX, port)."""
    rng = np.random.default_rng(0)
    js = ba_map(obs_noise=0.3)
    cols = rng.uniform(0, 255, (512, 3)).astype(np.float32)
    pv = np.asarray(js.point_valid) & (rng.random(512) > 0.2)
    cv = np.asarray(js.cam_valid).copy()
    cv[2] = False
    return jax_and_port(js._replace(colors=J(cols), point_valid=J(pv), cam_valid=J(cv)))


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_map_exports_byte_identical(maps, write_path, tmp_path):
    js, ts = maps
    n_j = jio.map_to_ply(str(tmp_path / "j.ply"), js)
    n_t = io.map_to_ply(str(tmp_path / "t.ply"), ts)
    assert n_t == n_j > 150
    assert _read(tmp_path / "t.ply") == _read(tmp_path / "j.ply")
    jio.map_pose_csv(str(tmp_path / "j.csv"), js)
    io.map_pose_csv(str(tmp_path / "t.csv"), ts)
    assert _read(tmp_path / "t.csv") == _read(tmp_path / "j.csv")


def test_to_ply_cleaning_byte_identical(write_path, tmp_path):
    """A dense-style cloud with far outliers: the same points are dropped."""
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 1.5, (5000, 3)).astype(np.float32)
    pts[:40] *= 30.0
    cols = rng.uniform(0, 255, (5000, 3)).astype(np.float32)
    n_j = jio.to_ply(str(tmp_path / "j.ply"), pts, cols)
    n_t = io.to_ply(str(tmp_path / "t.ply"), T(pts), T(cols))
    assert n_t == n_j and 4500 < n_t < 4960
    assert _read(tmp_path / "t.ply") == _read(tmp_path / "j.ply")


def test_read_ply_and_pose_csv_round_trip(maps, tmp_path):
    js, ts = maps
    n = io.map_to_ply(str(tmp_path / "m.ply"), ts, scale=1.0, outlier_offset=1e9)
    pts, cols = io.read_ply(str(tmp_path / "m.ply"))
    pv = N(ts.point_valid)
    assert len(pts) == n == int(pv.sum())
    np.testing.assert_allclose(pts, N(ts.points)[pv], atol=1e-6)  # %f: 6 decimals
    np.testing.assert_array_equal(cols, np.trunc(N(ts.colors)[pv]))
    jpts, jcols = jio.read_ply(str(tmp_path / "m.ply"))
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(cols, jcols)

    io.map_pose_csv(str(tmp_path / "pose.csv"), ts)
    K, P = io.load_pose_csv(str(tmp_path / "pose.csv"))
    cv = N(ts.cam_valid)
    np.testing.assert_allclose(K, N(ts.K), rtol=1e-7)
    poses = io.poses_from_projections(K, P)
    np.testing.assert_allclose(poses, N(ts.poses)[cv], atol=1e-6)
    np.testing.assert_array_equal(P, jio.load_pose_csv(str(tmp_path / "pose.csv"))[1])


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """A color test image (odd size 75 x 101) as PNG and as JPEG."""
    d = tmp_path_factory.mktemp("img")
    rng = np.random.default_rng(2)
    base = rng.uniform(0, 255, (19, 26, 3))
    rgb = np.kron(base, np.ones((4, 4, 1)))[:75, :101].astype(np.uint8)
    paths = {}
    for ext in ("png", "jpg"):
        paths[ext] = str(d / f"img.{ext}")
        Image.fromarray(rgb).save(paths[ext])
    return paths


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_decode_and_loader_match_jax(image_files, ext, write_path):
    path = image_files[ext]
    g, jg = native.decode_gray(path), jnative.decode_gray(path)
    b, jb = native.decode_bgr(path), jnative.decode_bgr(path)
    assert g.dtype == np.float32 and g.shape == (75, 101) and b.shape == (75, 101, 3)
    assert b.flags.c_contiguous  # goes to torch.as_tensor as it is
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(io.load_image_gray(path), jio.load_image_gray(path))
    loader = native.ImageLoader([path, path], downscale=2)
    jloader = jnative.ImageLoader([path, path], downscale=2)
    (lg, lb), (jlg, jlb) = loader.get(1), jloader.get(1)
    loader.close()
    jloader.close()
    assert lg.shape == (38, 51) and lb.shape == (38, 51, 3)
    if write_path == "native":
        np.testing.assert_array_equal(lg, jlg)
        np.testing.assert_array_equal(lb, jlb)
    else:  # the port's plain pyr_down against JAX's
        np.testing.assert_allclose(lg, jlg, atol=1e-6)
        np.testing.assert_allclose(lb, jlb, atol=1e-4)  # 0-255 scale


@pytest.mark.parametrize("shape", [(64, 80), (75, 101), (1, 7)])
def test_pyr_down_matches_jax(shape):
    """(h, w) -> ((h+1)//2, (w+1)//2); the plain version against JAX's
    ops/pyramid.pyr_down, and the native one (where it builds) bitwise."""
    img = np.random.default_rng(3).random(shape).astype(np.float32)
    ref = np.asarray(jpyramid.pyr_down(J(img)))
    out = N(pyramid.pyr_down(T(img)))
    assert out.shape == ((shape[0] + 1) // 2, (shape[1] + 1) // 2) == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)
    if native.available() and jnative.available():
        np.testing.assert_array_equal(native.pyr_down(img), jnative.pyr_down(img))


def test_metrics_logger_records(tmp_path):
    recs = [dict(event="frame", frame=1, reproj_error=0.25, wall_s=0.5),
            dict(event="ba", frame=2, initial_cost=1.5, final_cost=0.5, accepted=3),
            dict(event="frame", frame=2, reproj_error=0.75, wall_s=0.25)]
    lg = metrics.MetricsLogger(str(tmp_path / "t" / "m.jsonl"))
    jlg = jmetrics.MetricsLogger(str(tmp_path / "j.jsonl"))
    for r in recs:
        lg.log(**r)
        jlg.log(**r)
    with open(tmp_path / "t" / "m.jsonl") as fh:
        lines = [json.loads(x) for x in fh]
    assert [{k: v for k, v in x.items() if k != "ts"} for x in lines] == recs
    ours, theirs = lg.summary(), jlg.summary()
    # The port's rate counts the time between frames: frames over the wall
    # from the first frame's start to the last frame's end.
    frames = [r for r in lg.records if r["event"] == "frame"]
    wall = frames[-1]["ts"] - (frames[0]["ts"] - frames[0]["wall_s"])
    assert ours.pop("frames_per_s") == pytest.approx(2 / wall)
    theirs.pop("frames_per_s")
    assert ours == theirs
    assert ours["frames"] == 2 and ours["max_reproj_error"] == 0.75
