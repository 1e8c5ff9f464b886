"""The benchmark's scene: textured vertical strips at staggered depths.

A frozen copy of the port's staircase renderer
(``render_staircase_sequence``), rewritten in PyTorch so that a run renders
its frames and their ground-truth depths on the card in well under a
second instead of tens of seconds on the host. Rays and intersections are
computed in float64, the texture lookup in float32, as the numpy original
does, so both give the same frames to rounding (``tests/test_scene.py``).
Two changes against the original: the intrinsics are any (fx, fy, cx, cy),
not one focal length with the principal point at the image centre, and
the strips' depths (``geometry_seed``) and the texture (``texture_seed``)
come from separate seeds, so that every seed of a cell sees one geometry.

Nothing here imports the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SCENE_WIDTH = 6.0  # extent of the strip wall, world units
BACKGROUND = 0.12  # gray level where a ray meets no strip


class Scene(NamedTuple):
    images: torch.Tensor  # (N, H, W) float32 in [0, 1], on the device
    depths: torch.Tensor  # (N, H, W) float32 camera-frame z, 0 where no strip
    Rt: np.ndarray  # (N, 3, 4) float64 world->camera ground truth
    K: np.ndarray  # (3, 3) float64


def make_texture(size: int = 1024, seed: int = 0, octaves: int = 5) -> np.ndarray:
    """Multi-octave value-noise texture in [0, 1] (the port's
    ``make_texture``, copied unchanged)."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), dtype=np.float32)
    for o in range(octaves):
        n = 8 << o
        coarse = rng.random((n, n)).astype(np.float32)
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


def look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World->camera [R|t] looking from eye toward target (+z forward, -y up)."""
    up = np.array([0.0, -1.0, 0.0])
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return np.concatenate([R, (-R @ eye)[:, None]], axis=1)


def camera_path(num_cameras: int, radius: float, arc_degrees: float) -> np.ndarray:
    """(N, 3, 4) float64 poses on the original's arc around the origin."""
    angles = np.deg2rad(np.linspace(-arc_degrees / 2, arc_degrees / 2, num_cameras))
    eyes = [np.array([radius * np.sin(a), -0.4 * np.sin(2 * a), -radius * np.cos(a)])
            for a in angles]
    # look_at's float32 rounding in the original is kept: the ground truth
    # is the pose the frames were rendered from.
    return np.stack([look_at(e, np.zeros(3)).astype(np.float32) for e in eyes]).astype(np.float64)


def render(num_cameras: int, image_size, fx: float, fy: float, cx: float, cy: float,
           radius: float, arc_degrees: float, num_strips: int, depth_spread: float,
           geometry_seed: int, texture_seed: int, device, texture_size: int = 1024) -> Scene:
    """Render the sequence on `device`: frames, depths and ground truth."""
    W, H = image_size
    tex = torch.as_tensor(make_texture(texture_size, seed=texture_seed), device=device)
    strip_depths = (np.random.default_rng(geometry_seed + 7).random(num_strips) - 0.5) \
        * 2.0 * depth_spread
    strip_w = SCENE_WIDTH / num_strips
    K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=np.float32)
    Kinv = torch.as_tensor(np.linalg.inv(K.astype(np.float64)), device=device)
    Rt = camera_path(num_cameras, radius, arc_degrees)
    f64 = dict(dtype=torch.float64, device=device)
    v, u = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64), indexing="ij")
    rays = torch.stack([u, v, torch.ones_like(u)], dim=-1) @ Kinv.T  # (H, W, 3)
    images, depths = [], []
    T = texture_size
    for pose in torch.as_tensor(Rt, **f64):
        R, t = pose[:, :3], pose[:, 3]
        origin = -R.T @ t
        dirs = rays @ R
        img = torch.full((H, W), BACKGROUND, dtype=torch.float32, device=device)
        best_t = torch.full((H, W), float("inf"), **f64)
        dn = dirs[..., 2]
        for i in range(num_strips):
            x_lo = -SCENE_WIDTH / 2 + i * strip_w
            num = float(strip_depths[i]) - origin[2]
            tt = torch.where(dn.abs() > 1e-9, num / dn, torch.full_like(dn, float("inf")))
            pu = origin[0] + tt * dirs[..., 0]
            pv = origin[1] + tt * dirs[..., 1]
            ok = ((tt > 0.1) & (pu >= x_lo) & (pu < x_lo + strip_w)
                  & (pv.abs() <= SCENE_WIDTH / 2) & (tt < best_t))
            tu = torch.clamp((pu / SCENE_WIDTH + 0.5) * (T - 1), 0, T - 1)
            tv = torch.clamp((pv / SCENE_WIDTH + 0.5) * (T - 1), 0, T - 1)
            i0, j0 = torch.floor(tv), torch.floor(tu)
            fi = (tv - i0).float()
            fj = (tu - j0).float()
            i0, j0 = i0.long(), j0.long()
            i1 = torch.clamp_max(i0 + 1, T - 1)
            j1 = torch.clamp_max(j0 + 1, T - 1)
            val = (tex[i0, j0] * (1 - fi) * (1 - fj) + tex[i0, j1] * (1 - fi) * fj
                   + tex[i1, j0] * fi * (1 - fj) + tex[i1, j1] * fi * fj)
            img = torch.where(ok, val, img)
            best_t = torch.where(ok, tt, best_t)
        images.append(img)
        depths.append(torch.where(torch.isfinite(best_t), best_t, torch.zeros_like(best_t)).float())
    return Scene(images=torch.stack(images), depths=torch.stack(depths), Rt=Rt,
                 K=K.astype(np.float64))
