"""The port's SIFT with ``grad_sampling="bilinear"`` against the JAX package.

The non-deferred path: every octave candidate gets its orientations and
two descriptors from bilinearly interpolated (dx, dy) maps, then one
global top-K. Staircase frame at 320x240, max_features=512, exact top-k on
both sides. The nearest_polar test's margins (tests/test_torch_sift.py):
valid counts within 1%, positions within 1e-3 px for 99% of the valid
keypoints (paired by position and orientation, since keypoints whose
responses agree to rounding may swap slots), and the descriptors of paired
slots within 1e-3 per element.
"""

import numpy as np
import pytest
import torch

from _torch_parity import J, N, T

from sfm_mvs_tpu.ops import sift as jsift
from sfm_mvs_tpu_torch.ops import sift
from sfm_mvs_tpu_torch.utils.config import FrontendConfig
from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence

CFG = FrontendConfig(max_features=512, num_octaves=3, approx_topk=False,
                     contrast_threshold=0.015, grad_sampling="bilinear")


@pytest.fixture(scope="module")
def detections():
    import sfm_mvs_tpu.utils.config as jcfg

    imgs, _, _ = render_staircase_sequence(num_cameras=2, arc_degrees=20, image_size=(320, 240))
    jc = jcfg.FrontendConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
    return sift.detect_and_compute(T(imgs[0]), CFG), jsift.detect_and_compute(J(imgs[0]), jc)


def _pairs(ours, ref):
    v, vj = N(ours.valid), N(ref.valid)
    d = np.linalg.norm(N(ref.xy)[vj][:, None, :] - N(ours.xy)[v][None, :, :], axis=-1)
    dang = np.abs(np.angle(np.exp(1j * (N(ref.angle)[vj][:, None] - N(ours.angle)[v][None, :]))))
    nearest = (d + dang).argmin(1)
    return v, vj, nearest, d[np.arange(len(nearest)), nearest], dang[np.arange(len(nearest)),
                                                                       nearest]


def test_bilinear_keypoints_match_jax(detections):
    ours, ref = detections
    v, vj, nearest, dist, dang = _pairs(ours, ref)
    assert vj.sum() > 200
    assert abs(int(v.sum()) - int(vj.sum())) <= max(1, int(0.01 * vj.sum()))
    assert (dist < 1e-3).mean() >= 0.99
    assert (dang < 1e-3).mean() >= 0.99
    np.testing.assert_allclose(N(ours.response)[v][:50], N(ref.response)[vj][:50],
                               rtol=1e-4, atol=1e-7)


def test_bilinear_descriptors_match_jax(detections):
    ours, ref = detections
    v, vj, nearest, dist, dang = _pairs(ours, ref)
    same = (dist < 1e-3) & (dang < 1e-3)
    assert same.mean() > 0.95
    np.testing.assert_allclose(N(ours.desc)[v][nearest[same]], N(ref.desc)[vj][same], atol=1e-3)
    desc = N(ours.desc)[v]
    np.testing.assert_allclose(np.linalg.norm(desc, axis=1), 1.0, atol=1e-4)


def test_bilinear_gather_matches_jax():
    rng = np.random.default_rng(0)
    maps = rng.normal(size=(2, 3, 17, 23)).astype(np.float32)
    layer = rng.integers(0, 3, (40, 8))
    x = rng.uniform(-3, 26, (40, 8)).astype(np.float32)  # clamped outside the map
    y = rng.uniform(-3, 20, (40, 8)).astype(np.float32)
    ref = jsift._bilinear_gather(J(maps), J(layer.astype(np.int32)), J(x), J(y))
    ours = sift._bilinear_gather(T(maps), T(layer), T(x), T(y))
    np.testing.assert_allclose(N(ours), N(ref), rtol=1e-6, atol=1e-6)
    # A NaN coordinate reads a clamped index instead of failing.
    x[0, 0] = np.nan
    assert torch.isfinite(sift._bilinear_gather(T(maps), T(layer), T(x), T(y))[:, 1:]).all()
