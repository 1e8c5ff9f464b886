"""The port's SIFT detector against the JAX package's, on a staircase frame.

320x240, max_features=512, exact top-k on both sides. Valid keypoints are
compared in response order: the counts agree within 1%, positions within
1e-3 px, and paired descriptors have cosine > 0.999 (the bf16 polar
gradient maps round the same way in both). Slots are paired by position
rather than by index: keypoints whose responses agree to rounding may swap
places, and the order among zero-response (invalid) slots is arbitrary.
"""

import numpy as np
import pytest
import torch

from _torch_parity import J, N, T

from sfm_mvs_tpu.ops import pyramid as jpyr
from sfm_mvs_tpu.ops import sift as jsift
from sfm_mvs_tpu.utils.synthetic import render_staircase_sequence
from sfm_mvs_tpu_torch.ops import pyramid, sift
from sfm_mvs_tpu_torch.utils.config import FrontendConfig

CFG = FrontendConfig(max_features=512, num_octaves=3, approx_topk=False,
                     contrast_threshold=0.015)


@pytest.fixture(scope="module")
def frame():
    imgs, _, _ = render_staircase_sequence(num_cameras=2, arc_degrees=20, image_size=(320, 240))
    return imgs[0]


def _pair(ours, ref):
    """Pair each valid JAX keypoint with the port keypoint nearest in
    (position, orientation): a keypoint with a secondary orientation sits
    twice at one position. Returns (valid masks, pair index, xy distance)."""
    v, vj = N(ours.valid), N(ref.valid)
    d = np.linalg.norm(N(ref.xy)[vj][:, None, :] - N(ours.xy)[v][None, :, :], axis=-1)
    dang = np.abs(np.angle(np.exp(1j * (N(ref.angle)[vj][:, None] - N(ours.angle)[v][None, :]))))
    nearest = (d + dang).argmin(1)
    return v, vj, nearest, d[np.arange(len(nearest)), nearest]


@pytest.fixture(scope="module")
def detections(frame):
    import sfm_mvs_tpu.utils.config as jcfg

    jc = jcfg.FrontendConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
    ref = jsift.detect_and_compute(J(frame), jc)
    ours = sift.detect_and_compute(T(frame), CFG)
    return ours, ref


def test_pyramid_ops(frame):
    img = frame[:61, :83]  # odd sizes
    np.testing.assert_allclose(N(pyramid.upsample2(T(img))), N(jpyr.upsample2(J(img))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(N(pyramid.gaussian_blur(T(img), 1.3)),
                               N(jpyr.gaussian_blur(J(img), 1.3)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        N(pyramid.gaussian_scale_space(T(img), assumed_blur=1.0)),
        N(jpyr.gaussian_scale_space(J(img), assumed_blur=1.0)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(N(pyramid.subsample2(T(img))), N(jpyr.subsample2(J(img))))


def test_keypoints_match_jax(detections):
    ours, ref = detections
    v, vj = N(ours.valid), N(ref.valid)
    assert vj.sum() > 200
    assert abs(int(v.sum()) - int(vj.sum())) <= max(1, int(0.01 * vj.sum()))
    v, vj, nearest, dist = _pair(ours, ref)
    close = dist < 1e-3
    assert close.mean() >= 0.99
    # the valid slots come in response order in both, with equal responses
    np.testing.assert_allclose(N(ours.response)[v][:50], N(ref.response)[vj][:50],
                               rtol=1e-4, atol=1e-7)
    pairs = np.nonzero(close)[0]
    np.testing.assert_allclose(N(ours.scale)[v][nearest[pairs]], N(ref.scale)[vj][pairs],
                               rtol=1e-4, atol=1e-4)
    dang = np.angle(np.exp(1j * (N(ours.angle)[v][nearest[pairs]] - N(ref.angle)[vj][pairs])))
    assert np.mean(np.abs(dang) < 1e-3) > 0.99


def test_descriptors_match_jax(detections):
    ours, ref = detections
    v, vj, nearest, dist = _pair(ours, ref)
    same = (dist < 1e-3) & (
        np.abs(N(ours.angle)[v][nearest] - N(ref.angle)[vj]) < 1e-3)
    desc, descj = N(ours.desc)[v][nearest[same]], N(ref.desc)[vj][same]
    cos = np.sum(desc * descj, axis=1) / (
        np.linalg.norm(desc, axis=1) * np.linalg.norm(descj, axis=1))
    assert same.mean() > 0.95
    assert cos.min() > 0.999, cos.min()


def test_output_contract(detections):
    ours, _ = detections
    K = CFG.max_features
    assert ours.xy.shape == (K, 2) and ours.desc.shape == (K, 128)
    assert ours.valid.dtype == torch.bool and ours.xy.dtype == torch.float32
    desc = N(ours.desc)[N(ours.valid)]
    np.testing.assert_allclose(np.linalg.norm(desc, axis=1), 1.0, atol=1e-4)
