"""Host-side IO: image loading, PLY export, pose.csv export.

PyTorch port of ``sfm_mvs_tpu/utils/io.py``, writing the same bytes for the
same map. ``to_ply`` scales the cloud x200, drops points beyond
mean-centroid-distance + 300, and writes ASCII PLY with blue,green,red
uchar properties (sfm.py:169-201); pose.csv is one value per line,
[K.ravel(), P0.ravel(), P1.ravel(), ...] (sfm.py:276,334-335,423). A map's
tensors move to the host once, at export.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from sfm_mvs_tpu_torch.models.map_store import MapState

_PLY_HEADER = """ply
format ascii 1.0
element vertex {n}
property float x
property float y
property float z
property uchar blue
property uchar green
property uchar red
end_header
"""
_PLY_ROW = "%f %f %f %d %d %d\n"


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def load_image_gray(path: str, downscale: int = 1) -> np.ndarray:
    """Decode an image file to (H, W) float32 grayscale in [0, 1]: the native
    C++ decoder (native/sfm_native.cc) when built, PIL otherwise."""
    from sfm_mvs_tpu_torch import native

    if native.available():
        return native.decode_gray(path)
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), dtype=np.float32) / 255.0


def load_image_bgr(path: str) -> np.ndarray:
    """Decode to (H, W, 3) float32 BGR in [0, 255] (reference color order)."""
    from sfm_mvs_tpu_torch import native

    if native.available():
        return native.decode_bgr(path)
    from PIL import Image

    rgb = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)
    return np.ascontiguousarray(rgb[..., ::-1])


def list_images(img_dir: str) -> list[str]:
    """Sorted .jpg/.png listing (sfm.py:288-292)."""
    return [os.path.join(img_dir, name) for name in sorted(os.listdir(img_dir))
            if ".jpg" in name.lower() or ".png" in name.lower()]


def to_ply(path: str, points, colors, scale: float = 200.0,
           outlier_offset: float = 300.0) -> int:
    """Write an ASCII PLY with the reference's cleaning semantics.

    points: (N, 3); colors: (N, 3) BGR in [0, 255]. Returns #vertices kept.
    Cleaning: scale x`scale`, drop points farther than mean centroid
    distance + `outlier_offset` (sfm.py:170-181). The native writer when
    built; otherwise numpy, with np.savetxt's formatting per row.
    """
    from sfm_mvs_tpu_torch import native

    points, colors = _host(points), _host(colors)
    if native.available():
        return native.write_ply(path, points, colors, scale=scale,
                                outlier_offset=outlier_offset)
    pts = points.reshape(-1, 3) * scale
    cols = colors.reshape(-1, 3)
    mean = pts.mean(axis=0)
    dist = np.linalg.norm(pts - mean, axis=1)
    keep = dist < dist.mean() + outlier_offset
    verts = np.hstack([pts[keep], cols[keep]])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(_PLY_HEADER.format(n=len(verts)))
        # `fmt % tuple(row)` per row, as np.savetxt does, over Python floats
        # (the exact values of the float32 entries), in bounded chunks.
        for s in range(0, len(verts), 1 << 20):
            f.write("".join([_PLY_ROW % tuple(r) for r in verts[s:s + (1 << 20)].tolist()]))
    return int(keep.sum())


def read_ply(path: str):
    """Read an ASCII PLY written by `to_ply` back to (points, colors_bgr).

    Honors the header's property order (blue,green,red or red,green,blue
    both come back as BGR); list properties are not columns.
    """
    with open(path) as f:
        props = []
        n = 0
        in_vertex = False
        for line in f:
            tok = line.split()
            if tok[:1] == ["element"]:
                in_vertex = tok[1:2] == ["vertex"]
                if in_vertex:
                    n = int(tok[2])
            elif tok[:2] == ["property", "list"]:
                continue
            elif tok[:1] == ["property"] and in_vertex:
                props.append(tok[2])
            elif tok[:1] == ["end_header"]:
                break
        if n == 0 or not props:
            return np.zeros((0, 3), np.float32), None
        data = np.loadtxt(f, dtype=np.float64, max_rows=n)
    data = data.reshape(n, len(props))
    idx = {p: i for i, p in enumerate(props)}
    pts = data[:, [idx["x"], idx["y"], idx["z"]]].astype(np.float32)
    cols = None
    if "blue" in idx:
        cols = data[:, [idx["blue"], idx["green"], idx["red"]]].astype(np.float32)
    return pts, cols


def map_to_ply(path: str, state: MapState, scale: float = 200.0,
               outlier_offset: float = 300.0) -> int:
    """Export a MapState's valid points as PLY."""
    valid = _host(state.point_valid)
    return to_ply(path, _host(state.points)[valid], _host(state.colors)[valid],
                  scale=scale, outlier_offset=outlier_offset)


def save_pose_csv(path: str, K, poses: Sequence) -> None:
    """pose.csv: [K.ravel(), (K @ pose_i).ravel()...] one value per line.

    The reference stores projection matrices P = K [R|t] (sfm.py:317,365),
    starting with K itself (sfm.py:276).
    """
    K = np.asarray(_host(K), np.float64)
    arr = K.ravel()
    for pose in poses:
        arr = np.hstack([arr, (K @ np.asarray(_host(pose), np.float64)).ravel()])
    np.savetxt(path, arr, delimiter="\n")


def load_pose_csv(path: str):
    """Parse a pose.csv: flat [K(9), P_0(12), P_1(12), ...], one value per
    line. Returns (K (3,3), P (N,3,4) projection matrices)."""
    vals = np.loadtxt(path)
    K = vals[:9].reshape(3, 3)
    rest = vals[9:]
    n = len(rest) // 12
    return K, rest[: n * 12].reshape(n, 3, 4)


def poses_from_projections(K: np.ndarray, P: np.ndarray) -> np.ndarray:
    """Recover [R|t] extrinsics from P = K [R|t] (for trajectory metrics)."""
    return np.einsum("ij,njk->nik", np.linalg.inv(K), P)


def map_pose_csv(path: str, state: MapState) -> None:
    valid = _host(state.cam_valid)
    save_pose_csv(path, _host(state.K), [p for p, v in zip(_host(state.poses), valid) if v])
