"""Headless visualization artifacts: overlays, camera frusta, error plot,
turntable GIF.

Port of ``sfm_mvs_tpu/utils/viz.py``, on numpy arrays (poses and points
moved to the host). The point overlay and the frusta PLY need numpy only;
the PNG writer needs PIL, the error plot matplotlib and the turntable GIF
matplotlib and PIL. Where one is not installed those functions raise the
``ImportError`` of its import, which names the package.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def draw_points(image_gray: np.ndarray, pts: np.ndarray, radius: int = 2,
                reproj: bool = True) -> np.ndarray:
    """Overlay points on a grayscale image -> (H, W, 3) uint8 RGB.

    The headless Draw_points (sfm.py:160-166): detected keypoints green
    (reproj=False), reprojected points red (reproj=True).
    """
    H, W = image_gray.shape
    img = np.repeat((np.clip(image_gray, 0, 1) * 255).astype(np.uint8)[..., None], 3, -1)
    color = np.array([255, 40, 40] if reproj else [40, 255, 40], dtype=np.uint8)
    for x, y in np.asarray(pts):
        xi, yi = int(round(x)), int(round(y))
        x0, x1 = max(xi - radius, 0), min(xi + radius + 1, W)
        y0, y1 = max(yi - radius, 0), min(yi + radius + 1, H)
        if x0 < x1 and y0 < y1:
            img[y0:y1, x0:x1] = color
    return img


def save_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W) or (H, W, 3) image as PNG (PIL)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(img).save(path)


def camera_frustum_vertices(Rt: np.ndarray, scale: float = 0.3) -> np.ndarray:
    """5 vertices of a camera frustum (apex + 4 image-plane corners) in world
    coordinates, from a world->camera [R|t]."""
    R = Rt[:, :3]
    t = Rt[:, 3]
    center = -R.T @ t
    corners_cam = np.array(
        [[-1, -0.75, 1.5], [1, -0.75, 1.5], [1, 0.75, 1.5], [-1, 0.75, 1.5]]) * scale
    corners = corners_cam @ R + center  # R.T @ c for each row
    return np.vstack([center[None, :], corners])


def save_camera_frusta_ply(path: str, poses: Sequence[np.ndarray], scale: float = 0.3) -> None:
    """Write all camera frusta as a wireframe PLY (vertices + edges)."""
    verts = []
    edges = []
    for i, Rt in enumerate(poses):
        verts.append(camera_frustum_vertices(np.asarray(Rt), scale))
        base = 5 * i
        for k in range(1, 5):
            edges.append((base, base + k))  # apex to corners
            edges.append((base + k, base + 1 + (k % 4)))  # image-plane loop
    verts = np.vstack(verts)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element edge {len(edges)}\n"
            "property int vertex1\nproperty int vertex2\nend_header\n"
        )
        np.savetxt(f, verts, "%f %f %f")
        for a, b in edges:
            f.write(f"{a} {b}\n")


def save_error_plot(path: str, errors: Sequence[float]) -> None:
    """Per-frame reprojection-error curve rendered to a PNG (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(7, 3))
    ax.scatter(range(len(errors)), errors, s=12)
    ax.set_xlabel("frame")
    ax.set_ylabel("mean reprojection error (px)")
    ax.set_title("Per-frame reprojection error")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def save_turntable_gif(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
                       poses: Optional[Sequence[np.ndarray]] = None, n_frames: int = 36,
                       elev: float = 12.0, point_size: float = 1.5, duration_ms: int = 80,
                       figsize=(5, 5)) -> None:
    """Orbiting-camera render of the reconstruction as an animated GIF
    (matplotlib + PIL): the cloud (+ camera centres when poses are given)
    seen from a camera orbiting its centroid, one frame per azimuth step."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    pts = np.asarray(points, np.float64)
    if len(pts) == 0:
        return
    # Robust extent: clip to the 2-98% quantile box so stray outliers
    # don't shrink the subject to a dot.
    lo = np.quantile(pts, 0.02, axis=0)
    hi = np.quantile(pts, 0.98, axis=0)
    keep = np.all((pts >= lo) & (pts <= hi), axis=1)
    pts = pts[keep]
    c = None
    if colors is not None:
        c = np.clip(np.asarray(colors)[keep][:, ::-1] / 255.0, 0, 1)  # BGR->RGB
    center = pts.mean(axis=0)
    span = float(np.max(pts.max(axis=0) - pts.min(axis=0))) * 0.55 + 1e-6

    cam_pts = None
    if poses is not None and len(poses):
        cam_pts = np.stack([-np.asarray(Rt)[:, :3].T @ np.asarray(Rt)[:, 3] for Rt in poses])

    frames = []
    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")
    for k in range(n_frames):
        ax.cla()
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=point_size, c=c,
                   marker=".", linewidths=0, depthshade=False)
        if cam_pts is not None:
            ax.plot(cam_pts[:, 0], cam_pts[:, 1], cam_pts[:, 2], "r-", lw=1.0)
            ax.scatter(cam_pts[:, 0], cam_pts[:, 1], cam_pts[:, 2], s=6, c="red",
                       marker="^", depthshade=False)
        ax.set_xlim(center[0] - span, center[0] + span)
        ax.set_ylim(center[1] - span, center[1] + span)
        ax.set_zlim(center[2] - span, center[2] + span)
        ax.view_init(elev=elev, azim=360.0 * k / n_frames)
        ax.set_axis_off()
        fig.tight_layout(pad=0)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(Image.fromarray(buf.copy()))
    plt.close(fig)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=duration_ms, loop=0, optimize=True)
