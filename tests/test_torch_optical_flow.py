"""The port's pyramidal Lucas-Kanade tracker (ops/optical_flow.py) against JAX.

Tolerances. Both packages run the same float32 arithmetic in the same
order, but sum each 225-pixel patch in another order, so: tracked positions
within 1e-3 px where both are valid; patch errors within 1e-5; valid masks
identical, except for a point whose error lies within 1e-4 of max_error or
whose structure tensor's smallest eigenvalue per pixel lies within 1e-6
(relative) of min_eig at some level. The inputs are tests/test_optical_flow.py's
shifted texture pair (160x160, 64 points) and a staircase pair (320x240,
256 SIFT points). Also that test's known-translation check (median flow
within 0.2 px of -d), its invalid-input masking, and a point whose patch
crosses the image border.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import J, N, T

from sfm_mvs_tpu.ops import optical_flow as jof
from sfm_mvs_tpu_torch.ops import optical_flow, pyramid, sift
from sfm_mvs_tpu_torch.utils.config import FrontendConfig
from sfm_mvs_tpu_torch.utils.synthetic import make_texture, render_staircase_sequence

MAX_ERROR = 0.15
MIN_EIG = 1e-4


def _shifted_pair(dx=3.2, dy=-2.4, size=160):
    """tests/test_optical_flow.py's pair: img1(x) = img0(x + d), bilinear."""
    tex = make_texture(256, seed=3)
    img0 = tex[40:40 + size, 40:40 + size].astype(np.float32)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float64)
    x1 = np.clip(xs + dx, 0, 255 - 40 - 1)
    y1 = np.clip(ys + dy, 0, 255 - 40 - 1)
    x0i, y0i = np.floor(x1).astype(int), np.floor(y1).astype(int)
    fx, fy = (x1 - x0i).astype(np.float32), (y1 - y0i).astype(np.float32)
    big = tex[40:, 40:]
    xn, yn = np.minimum(x0i + 1, big.shape[1] - 1), np.minimum(y0i + 1, big.shape[0] - 1)
    img1 = (big[y0i, x0i] * (1 - fy) * (1 - fx) + big[y0i, xn] * (1 - fy) * fx
            + big[yn, x0i] * fy * (1 - fx) + big[yn, xn] * fy * fx).astype(np.float32)
    return img0, img1, (dx, dy)


def _staircase_pair():
    imgs, _, _ = render_staircase_sequence(num_cameras=2, image_size=(320, 240), arc_degrees=6)
    f = sift.detect_and_compute(T(imgs[0]), FrontendConfig(max_features=256, num_octaves=3,
                                                           contrast_threshold=0.015))
    return imgs[0], imgs[1], N(f.xy), N(f.valid)


def _borderline_eig(img0, pts, levels=3, r=7):
    """Points whose smallest structure-tensor eigenvalue per pixel lies
    within 1e-6 (relative) of MIN_EIG at some level (float64 recompute)."""
    g = torch.as_tensor(img0)
    lin = torch.arange(-r, r + 1, dtype=torch.float32)
    oy, ox = torch.meshgrid(lin, lin, indexing="ij")
    offs = torch.stack([ox.reshape(-1), oy.reshape(-1)], -1)
    near = np.zeros(len(pts), bool)
    p = torch.as_tensor(pts)
    for lvl in range(levels):
        b = p * (0.5 ** lvl)
        s = optical_flow._sample_patch
        gx = 0.5 * (s(g, b[:, 0] + 1, b[:, 1], offs) - s(g, b[:, 0] - 1, b[:, 1], offs))
        gy = 0.5 * (s(g, b[:, 0], b[:, 1] + 1, offs) - s(g, b[:, 0], b[:, 1] - 1, offs))
        gx, gy = N(gx).astype(np.float64), N(gy).astype(np.float64)
        a, bb, c = (gx * gx).sum(1), (gx * gy).sum(1), (gy * gy).sum(1)
        tr = a + c
        eig = 0.5 * (tr - np.sqrt(np.maximum(tr * tr - 4 * (a * c - bb * bb), 0))) / offs.shape[0]
        near |= np.abs(eig - MIN_EIG) <= 1e-6 * MIN_EIG
        g = pyramid.pyr_down(g)
    return near


@pytest.mark.parametrize("case", ["shifted", "staircase"])
def test_track_points_matches_jax(case):
    if case == "shifted":
        img0, img1, _ = _shifted_pair()
        pts = np.random.default_rng(0).uniform(25, 135, (64, 2)).astype(np.float32)
        valid = np.ones(64, bool)
    else:
        img0, img1, pts, valid = _staircase_pair()
    ref = jof.track_points(J(img0), J(img1), J(pts), J(valid))
    ours = optical_flow.track_points(T(img0), T(img1), T(pts), T(valid))
    v, vr = N(ours.valid), N(ref.valid)
    assert 0.3 < v.mean() < 1.0
    np.testing.assert_allclose(N(ours.error), N(ref.error), atol=1e-5)
    both = v & vr
    np.testing.assert_allclose(N(ours.points)[both], N(ref.points)[both], atol=1e-3)
    exempt = (np.abs(N(ref.error) - MAX_ERROR) <= 1e-4) | _borderline_eig(img0, pts)
    np.testing.assert_array_equal(v[~exempt], vr[~exempt])


def test_tracks_known_translation():
    img0, img1, (dx, dy) = _shifted_pair()
    pts = np.random.default_rng(0).uniform(25, 135, size=(64, 2)).astype(np.float32)
    res = optical_flow.track_points(T(img0), T(img1), T(pts), torch.ones(64, dtype=torch.bool))
    v = N(res.valid)
    assert v.mean() > 0.5
    flow = N(res.points) - pts
    np.testing.assert_allclose(np.median(flow[v], axis=0), [-dx, -dy], atol=0.2)


def test_invalid_inputs_masked():
    img0, img1, _ = _shifted_pair()
    pts = np.array([[80.0, 80.0], [2.0, 2.0]], np.float32)
    res = optical_flow.track_points(T(img0), T(img1), T(pts), torch.tensor([True, False]))
    assert not bool(res.valid[1])
    assert bool(res.valid[0])


def test_patch_across_the_border():
    """Gather indices are clamped: a patch reaching past the image (and a
    NaN position) samples edge pixels instead of raising, and such points
    come back invalid."""
    img0, img1, _ = _shifted_pair()
    pts = np.array([[1.0, 80.0], [158.5, 159.0], [-40.0, 300.0], [np.nan, 5.0], [80.0, 80.0]],
                   np.float32)
    res = optical_flow.track_points(T(img0), T(img1), T(pts), torch.ones(5, dtype=torch.bool))
    v = N(res.valid)
    assert not v[:4].any() and v[4]
    ref = jof.track_points(J(img0), J(img1), J(pts), jnp.ones(5, bool))
    np.testing.assert_array_equal(v, N(ref.valid))


def test_numpy_images_default_to_cuda():
    img0, img1, _ = _shifted_pair()
    pts = np.zeros((2, 2), np.float32)
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the cuda default runs here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        optical_flow.track_points(img0, img1, pts, np.ones(2, bool))
    res = optical_flow.track_points(img0, img1, pts, np.ones(2, bool), device="cpu")
    assert res.points.device.type == "cpu"
