"""Synthetic staircase and plane scenes for tests and the smoke run.

The part of ``sfm_mvs_tpu/utils/synthetic.py`` that the port's paths use,
copied unchanged (numpy only): :func:`render_staircase_sequence`,
:func:`render_plane_sequence` (the global pipeline's scene) and the helpers
they call. Both packages render bitwise-identical images from the same
arguments.
"""

from __future__ import annotations

import numpy as np


def look_at(eye: np.ndarray, target: np.ndarray, up=None) -> np.ndarray:
    """World->camera [R|t] looking from eye toward target (+z forward)."""
    if up is None:
        up = np.array([0.0, -1.0, 0.0])
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])  # rows are camera axes in world coords
    t = -R @ eye
    return np.concatenate([R, t[:, None]], axis=1).astype(np.float32)


def make_texture(size: int = 1024, seed: int = 0, octaves: int = 5) -> np.ndarray:
    """Multi-octave value-noise texture in [0,1], rich in corners/blobs."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), dtype=np.float32)
    for o in range(octaves):
        n = 8 << o
        coarse = rng.random((n, n)).astype(np.float32)
        # bilinear upsample to full size
        idx = np.linspace(0, n - 1, size)
        i0 = np.floor(idx).astype(int)
        i1 = np.minimum(i0 + 1, n - 1)
        f = (idx - i0).astype(np.float32)
        up = (
            coarse[np.ix_(i0, i0)] * np.outer(1 - f, 1 - f)
            + coarse[np.ix_(i0, i1)] * np.outer(1 - f, f)
            + coarse[np.ix_(i1, i0)] * np.outer(f, 1 - f)
            + coarse[np.ix_(i1, i1)] * np.outer(f, f)
        )
        tex += up / (1 << o)
    tex -= tex.min()
    tex /= tex.max()
    return tex


def render_staircase_sequence(
    num_cameras: int = 8,
    image_size=(320, 240),
    focal: float = 400.0,
    radius: float = 8.0,
    arc_degrees: float = 40.0,
    num_strips: int = 8,
    depth_spread: float = 2.0,
    texture_size: int = 1024,
    seed: int = 0,
    return_depth: bool = False,
    texture: "np.ndarray | None" = None,
    dist: "tuple[float, float]" = (0.0, 0.0),
):
    """Render vertical textured strips at staggered depths (a "staircase").

    Rich noise texture (distinctive SIFT descriptors) combined with strong
    depth variation across strips — no dominant plane, so essential-matrix
    estimation is well-conditioned. This is the primary synthetic sequence
    for end-to-end pipeline tests and benchmarks. Returns (images,
    Rt (C,3,4), K (3,3)).

    texture: optional square (T, T) float image in [0, 1] to texture the
    strips with instead of the synthetic value noise — pass a real
    photograph (``sfm_mvs_tpu.utils.synthetic.load_image_texture``) to exercise the detector
    and matcher on real contrast/gradient statistics while keeping exact
    ground-truth geometry.
    """
    if texture is not None:
        tex = np.asarray(texture, np.float32)
        assert tex.ndim == 2 and tex.shape[0] == tex.shape[1], "square (T,T)"
        texture_size = tex.shape[0]
    else:
        tex = make_texture(texture_size, seed=seed)
    rng = np.random.default_rng(seed + 7)
    W, H = image_size
    K = np.array(
        [[focal, 0.0, W / 2.0], [0.0, focal, H / 2.0], [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )
    s = 6.0  # scene width/height
    strip_w = s / num_strips
    depths = (rng.random(num_strips) - 0.5) * 2.0 * depth_spread  # z offsets
    ex = np.array([1.0, 0, 0])
    ey = np.array([0, 1.0, 0])
    ez = np.array([0, 0, 1.0])
    angles = np.deg2rad(np.linspace(-arc_degrees / 2, arc_degrees / 2, num_cameras))
    Rts, images, depth_maps = [], [], []
    Kinv = np.linalg.inv(K)
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    pix = np.stack([u, v, np.ones_like(u)], axis=-1)
    if dist[0] != 0.0 or dist[1] != 0.0:
        # Output pixels are coordinates in the DISTORTED image: invert the
        # radial model x_d = x (1 + k1 r^2 + k2 r^4) by fixed point to get
        # the ideal ray each distorted pixel observes (matches
        # projection.undistort_normalized).
        xy_d = (pix @ Kinv.T)[..., :2]
        xy = xy_d.copy()
        for _ in range(8):
            r2 = np.sum(xy * xy, axis=-1, keepdims=True)
            f = 1.0 + dist[0] * r2 + dist[1] * r2 * r2
            xy = xy_d / np.maximum(np.abs(f), 1e-12) * np.sign(f)
        pix = np.concatenate([xy, np.ones_like(xy[..., :1])], axis=-1)
        Kinv = np.eye(3)  # pix already holds normalized ideal rays
    for a in angles:
        eye = np.array([radius * np.sin(a), -0.4 * np.sin(2 * a), -radius * np.cos(a)])
        Rt = look_at(eye, np.zeros(3))
        Rts.append(Rt)
        R = Rt[:, :3].astype(np.float64)
        t = Rt[:, 3].astype(np.float64)
        origin = -R.T @ t
        dirs = (pix @ Kinv.T) @ R
        img = np.full((H, W), 0.12, dtype=np.float32)
        best_t = np.full((H, W), np.inf)
        for i in range(num_strips):
            x_lo = -s / 2 + i * strip_w
            p0 = np.array([0.0, 0.0, depths[i]])
            n = ez
            dn = dirs @ n
            tt = np.where(np.abs(dn) > 1e-9, ((p0 - origin) @ n) / dn, np.inf)
            hit = origin[None, None, :] + tt[..., None] * dirs
            pu = hit @ ex
            pv = hit @ ey
            ok = (
                (tt > 0.1)
                & (pu >= x_lo)
                & (pu < x_lo + strip_w)
                & (np.abs(pv) <= s / 2)
                & (tt < best_t)
            )
            tu = np.clip((pu / s + 0.5) * (texture_size - 1), 0, texture_size - 1)
            tv = np.clip((pv / s + 0.5) * (texture_size - 1), 0, texture_size - 1)
            i0 = np.floor(tv).astype(int)
            j0 = np.floor(tu).astype(int)
            i1 = np.minimum(i0 + 1, texture_size - 1)
            j1 = np.minimum(j0 + 1, texture_size - 1)
            fi = (tv - i0).astype(np.float32)
            fj = (tu - j0).astype(np.float32)
            val = (
                tex[i0, j0] * (1 - fi) * (1 - fj)
                + tex[i0, j1] * (1 - fi) * fj
                + tex[i1, j0] * fi * (1 - fj)
                + tex[i1, j1] * fi * fj
            )
            img = np.where(ok, val, img).astype(np.float32)
            best_t = np.where(ok, tt, best_t)
        images.append(img)
        # best_t is the camera-frame z depth: ray dirs come from K^-1 p,
        # whose camera z component is exactly 1.
        depth_maps.append(np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32))
    if return_depth:
        return images, np.stack(Rts).astype(np.float32), K, depth_maps
    return images, np.stack(Rts).astype(np.float32), K


def render_plane_sequence(
    num_cameras: int = 8,
    image_size=(320, 240),
    focal: float = 400.0,
    plane_size: float = 4.0,
    radius: float = 6.0,
    arc_degrees: float = 60.0,
    texture_size: int = 1024,
    seed: int = 0,
):
    """Render a textured 3D plane (z=0, |x|,|y|<=s/2) from a camera ring.

    Returns (images: list[(H,W) float32 in [0,1]], Rt: (C,3,4), K: (3,3)).
    Rendering is exact inverse-homography bilinear sampling, so SIFT-style
    features are realistically detectable and matchable across views and the
    recovered geometry can be compared to the ground-truth poses.
    """
    tex = make_texture(texture_size, seed=seed)
    W, H = image_size
    K = np.array(
        [[focal, 0.0, W / 2.0], [0.0, focal, H / 2.0], [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )
    angles = np.deg2rad(np.linspace(0.0, arc_degrees, num_cameras))
    Rts, images = [], []
    # Plane param: world (x, y, 0) with x,y in [-s/2, s/2] -> texture coords.
    s = plane_size
    for a in angles:
        eye = np.array([radius * np.sin(a), 0.2 * np.sin(3 * a), -radius * np.cos(a)])
        Rt = look_at(eye, np.zeros(3))
        Rts.append(Rt)
        # Homography from image pixels to plane coords: for plane z=0,
        # x_img ~ K [r1 r2 t] [X Y 1]^T  =>  plane->image H, invert.
        Hpi = K @ np.stack([Rt[:, 0], Rt[:, 1], Rt[:, 3]], axis=1)
        Hip = np.linalg.inv(Hpi)
        u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
        ones = np.ones_like(u)
        pix = np.stack([u, v, ones], axis=-1) @ Hip.T
        X = pix[..., 0] / pix[..., 2]
        Y = pix[..., 1] / pix[..., 2]
        # plane coords -> texture pixel coords
        tu = (X / s + 0.5) * (texture_size - 1)
        tv = (Y / s + 0.5) * (texture_size - 1)
        inside = (tu >= 0) & (tu <= texture_size - 1) & (tv >= 0) & (tv <= texture_size - 1)
        tu = np.clip(tu, 0, texture_size - 1)
        tv = np.clip(tv, 0, texture_size - 1)
        i0 = np.floor(tv).astype(int)
        j0 = np.floor(tu).astype(int)
        i1 = np.minimum(i0 + 1, texture_size - 1)
        j1 = np.minimum(j0 + 1, texture_size - 1)
        fi = (tv - i0).astype(np.float32)
        fj = (tu - j0).astype(np.float32)
        img = (
            tex[i0, j0] * (1 - fi) * (1 - fj)
            + tex[i0, j1] * (1 - fi) * fj
            + tex[i1, j0] * fi * (1 - fj)
            + tex[i1, j1] * fi * fj
        )
        img = np.where(inside, img, 0.12).astype(np.float32)
        images.append(img)
    return images, np.stack(Rts), K
