"""The card's renderer against the port's numpy original at a small size."""

import numpy as np
import torch

from portbench import scene


def test_device_renderer_matches_the_numpy_original():
    from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence

    kw = dict(num_cameras=4, radius=9.0, arc_degrees=50.0, num_strips=10, depth_spread=2.0)
    imgs, Rt, K, depths = render_staircase_sequence(image_size=(96, 64), focal=120.0, seed=3,
                                                    texture_size=256, return_depth=True, **kw)
    sc = scene.render(image_size=(96, 64), fx=120.0, fy=120.0, cx=48.0, cy=32.0,
                      geometry_seed=3, texture_seed=3, device=torch.device("cpu"),
                      texture_size=256, **kw)
    np.testing.assert_allclose(sc.Rt, Rt, rtol=0, atol=0)
    np.testing.assert_allclose(sc.K, K, rtol=0, atol=0)
    got, want = sc.images.numpy(), np.stack(imgs)
    # float64 products in another order: texture coordinates agree to
    # ~1e-12, so a pixel differs only where a ray grazes a strip's edge.
    close = np.abs(got - want) < 1e-5
    assert close.mean() > 0.999
    d_got, d_want = sc.depths.numpy(), np.stack(depths)
    np.testing.assert_allclose(d_got[close], d_want[close], rtol=1e-6)


def test_texture_and_geometry_seeds_are_separate():
    kw = dict(num_cameras=2, image_size=(32, 24), fx=40.0, fy=40.0, cx=16.0, cy=12.0,
              radius=9.0, arc_degrees=10.0, num_strips=10, depth_spread=2.0,
              device=torch.device("cpu"), texture_size=64)
    a = scene.render(geometry_seed=0, texture_seed=1, **kw)
    b = scene.render(geometry_seed=0, texture_seed=2, **kw)
    c = scene.render(geometry_seed=0, texture_seed=1, **kw)
    assert not torch.equal(a.images, b.images)
    assert torch.equal(a.images, c.images) and torch.equal(a.depths, b.depths)
