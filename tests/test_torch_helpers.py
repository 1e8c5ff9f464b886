"""The port's leaf helpers against the JAX package.

Tolerances. Numpy-only code (the synthetic scenes and renderers, the
trajectory and texture loaders, ``viz.draw_points``) is a copy and must
agree bitwise. Tensor code agrees within 1e-6 (relative for
``compose_projection``, whose entries reach ~500): ``img_downscale``,
``rgb_to_gray``, ``to_homogeneous``, ``compose_projection`` and the
masking helpers. ``fundamental_eight_point`` on 60 correspondences with
0.3 px noise, up to the sign of the null vector (LAPACK and XLA may return
either): LAPACK's and XLA's float32 SVDs of the design matrix differ at
~1e-5, which the de-normalization's cancellation amplifies in the
pixel-space F, so entries agree within 1e-3 of max|F| and Sampson
distances within 1e-3 px; F has rank 2. The port's tracer
(``utils/profiling.py``) has its own tests in tests/test_torch_tracing.py.
"""

import numpy as np
import pytest
import torch

from _torch_parity import J, N, T

from sfm_mvs_tpu.ops import epipolar as jepipolar
from sfm_mvs_tpu.ops import masking as jmasking
from sfm_mvs_tpu.ops import projection as jprojection
from sfm_mvs_tpu.ops import pyramid as jpyramid
from sfm_mvs_tpu.ops import sift as jsift
from sfm_mvs_tpu.utils import synthetic as jsyn
from sfm_mvs_tpu.utils import viz as jviz
from sfm_mvs_tpu_torch.ops import epipolar, masking, projection, pyramid, sift
from sfm_mvs_tpu_torch.utils import synthetic, viz


def test_fundamental_eight_point_matches_jax():
    rng = np.random.default_rng(0)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    X = rng.uniform(-2, 2, (60, 3)).astype(np.float32) + [0, 0, 8]
    R = synthetic.look_at(np.array([1.5, 0.2, -8.0]), np.zeros(3))[:, :3]
    Rt1 = np.concatenate([R, np.array([[0.5], [0.1], [0.2]], np.float32)], 1)

    def proj(Rt):
        h = (X @ Rt[:, :3].T + Rt[:, 3]) @ K.T
        uv = h[:, :2] / h[:, 2:]
        return (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)

    uv0, uv1 = proj(np.eye(3, 4, dtype=np.float32)), proj(Rt1)
    mask = rng.random(60) > 0.2
    for m in (None, mask):
        F = N(epipolar.fundamental_eight_point(T(uv0), T(uv1), None if m is None else T(m)))
        Fj = np.asarray(jepipolar.fundamental_eight_point(J(uv0), J(uv1),
                                                          None if m is None else J(m)))
        Fj = Fj * np.sign(np.sum(F * Fj))
        np.testing.assert_allclose(F, Fj, atol=1e-3 * np.abs(Fj).max())
        d, dj = (np.sqrt(N(epipolar.sampson_error(T(f), T(uv0), T(uv1)))) for f in (F, Fj))
        np.testing.assert_allclose(d, dj, atol=1e-3)
        assert d.max() < 2.0
        assert abs(np.linalg.det(F.astype(np.float64))) < 1e-5 * np.abs(F).max() ** 3


@pytest.mark.parametrize("downscale", [1, 2, 4])
def test_img_downscale_matches_jax(downscale):
    img = synthetic.make_texture(128, seed=1)[:100, :90]
    out = pyramid.img_downscale(T(img), downscale)
    ref = jpyramid.img_downscale(J(img), downscale)
    assert out.shape == ref.shape
    np.testing.assert_allclose(N(out), N(ref), atol=1e-6)


def test_rgb_to_gray_matches_jax():
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    f = rng.random((12, 10, 3)).astype(np.float32) * 255
    g2 = rng.random((12, 10)).astype(np.float32)
    for img in (u8, f, g2):
        out, ref = sift.rgb_to_gray(T(img)), jsift.rgb_to_gray(J(img))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(N(out), N(ref), atol=1e-6)
    assert float(sift.rgb_to_gray(T(u8)).max()) <= 1.0 < float(sift.rgb_to_gray(T(f)).max())


def test_homogeneous_and_projection_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(4, 5, 2)).astype(np.float32)
    np.testing.assert_array_equal(N(projection.to_homogeneous(T(pts))),
                                  N(jprojection.to_homogeneous(J(pts))))
    K = np.array([[400.0, 0, 160], [0, 410.0, 120], [0, 0, 1]], np.float32)
    Rt = rng.normal(size=(3, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(N(projection.compose_projection(T(K), T(Rt))),
                               N(jprojection.compose_projection(J(K), J(Rt))), rtol=1e-6)


def test_masking_helpers_match_jax():
    rng = np.random.default_rng(4)
    mask = rng.random(40) > 0.4
    vals = rng.normal(size=(40, 3)).astype(np.float32)
    compacted = N(masking.compact(T(mask), T(vals))[2])
    back = masking.scatter_back(T(mask), T(compacted))
    np.testing.assert_array_equal(N(back), vals)
    np.testing.assert_array_equal(N(back), N(jmasking.scatter_back(J(mask), J(compacted))))
    x = rng.normal(size=(6, 7)).astype(np.float32)
    m2 = rng.random((6, 7)) > 0.5
    m2[2] = False
    for axis in (None, 0, 1):
        np.testing.assert_allclose(N(masking.masked_mean(T(x), T(m2), axis=axis)),
                                   N(jmasking.masked_mean(J(x), J(m2), axis=axis)), atol=1e-6)
    assert float(masking.masked_mean(T(x[2]), T(m2[2]))) == 0.0
    for cap, fill in ((10, 0), (10, -1), (4, 0)):
        out = masking.pad_to(T(vals[:6]), cap, fill=fill)
        np.testing.assert_array_equal(N(out), N(jmasking.pad_to(J(vals[:6]), cap, fill=fill)))
    ints = masking.pad_to(torch.arange(3, dtype=torch.int32), 5, fill=-1)
    assert ints.dtype == torch.int32 and ints.tolist() == [0, 1, 2, -1, -1]


def test_draw_points_and_save_png(tmp_path):
    img = synthetic.make_texture(64, seed=2)[:40, :50]
    pts = np.array([[3.4, 5.6], [49.0, 39.0], [-10.0, 5.0], [25.5, 20.5]], np.float32)
    for reproj in (True, False):
        out = viz.draw_points(img, pts, radius=2, reproj=reproj)
        np.testing.assert_array_equal(out, jviz.draw_points(img, pts, radius=2, reproj=reproj))
    assert out.shape == (40, 50, 3) and out.dtype == np.uint8
    path = str(tmp_path / "sub" / "overlay.png")
    viz.save_png(path, out)
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(path)), out)


def test_scenes_and_renderers_bitwise():
    s, sj = synthetic.make_scene(num_points=50, num_cameras=3), jsyn.make_scene(num_points=50,
                                                                               num_cameras=3)
    for f in ("points", "Rt", "K"):
        np.testing.assert_array_equal(getattr(s, f), getattr(sj, f))
    np.testing.assert_array_equal(s.project(1)[0], sj.project(1)[0])
    imgs, sc = synthetic.render_splat_sequence(num_cameras=2, num_points=300, image_size=(64, 48))
    jimgs, jsc = jsyn.render_splat_sequence(num_cameras=2, num_points=300, image_size=(64, 48))
    np.testing.assert_array_equal(np.stack(imgs), np.stack(jimgs))
    c = synthetic.render_corner_sequence(num_cameras=2, image_size=(64, 48), texture_size=128)
    cj = jsyn.render_corner_sequence(num_cameras=2, image_size=(64, 48), texture_size=128)
    np.testing.assert_array_equal(np.stack(c[0]), np.stack(cj[0]))
    np.testing.assert_array_equal(c[1], cj[1])
    assert np.allclose(synthetic.estimate_lookat_target(s.Rt),
                       jsyn.estimate_lookat_target(sj.Rt), atol=0, rtol=0)


def test_solid_texture_object_bitwise():
    tex = synthetic.make_texture3d(size=32, octaves=3)
    np.testing.assert_array_equal(tex, jsyn.make_texture3d(size=32, octaves=3))
    p = np.random.default_rng(5).uniform(0, 3, (20, 3))
    np.testing.assert_array_equal(synthetic._tex3_sample(tex, p, 8.0), jsyn._tex3_sample(tex, p, 8.0))
    scene = synthetic.make_scene(num_cameras=2, image_size=(48, 32), focal=40.0)
    out = synthetic.render_object_from_poses(scene.Rt, scene.K, image_size=(48, 32),
                                             return_depth=True)
    ref = jsyn.render_object_from_poses(scene.Rt, scene.K, image_size=(48, 32), return_depth=True)
    np.testing.assert_array_equal(np.stack(out[0]), np.stack(ref[0]))
    np.testing.assert_array_equal(np.stack(out[2]), np.stack(ref[2]))


def test_loaders_bitwise(tmp_path):
    scene = synthetic.make_scene(num_cameras=3)
    Ps = scene.K.astype(np.float64) @ scene.Rt.astype(np.float64)
    path = str(tmp_path / "pose.csv")
    np.savetxt(path, np.concatenate([scene.K.ravel(), Ps.ravel()]))
    K, Rt = synthetic.load_reference_trajectory(path)
    Kj, Rtj = jsyn.load_reference_trajectory(path)
    np.testing.assert_array_equal(K, Kj)
    np.testing.assert_array_equal(Rt, Rtj)
    np.testing.assert_allclose(Rt, scene.Rt, atol=1e-5)

    from PIL import Image

    photo = (synthetic.make_texture(96, seed=4)[:80, :96] * 255).astype(np.uint8)
    png = str(tmp_path / "photo.png")
    Image.fromarray(photo).save(png)
    for size in (40, 32):  # an integer block mean of the 80 px square, then strided
        tex = synthetic.load_image_texture(png, size=size)
        assert tex.shape == (size, size) and tex.min() == 0.0 and tex.max() == 1.0
        try:
            ref = jsyn.load_image_texture(png, size=size)
        except (OSError, RuntimeError):
            continue  # the JAX package's native decoder is not built here
        np.testing.assert_array_equal(tex, ref)
