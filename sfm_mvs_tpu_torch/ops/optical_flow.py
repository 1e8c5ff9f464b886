"""Pyramidal Lucas-Kanade feature tracking.

PyTorch port of ``sfm_mvs_tpu/ops/optical_flow.py``: the tracker of the
reference's disabled ``cv2.calcOpticalFlowPyrLK`` front end (sfm.py:249-257).
Per pyramid level, coarse to fine, each keypoint samples a (2r+1)^2 patch
of the previous image and its central-difference gradients (bilinear
gathers), builds the 2x2 structure tensor and iterates the closed-form LK
step against the next image a fixed number of times.

The JAX package vmaps one keypoint's program over the keypoints; here every
step is one whole-batch tensor op over the (N,) keypoint axis, each patch an
(N, P) gather, in the JAX package's arithmetic order. Gather indices are
clamped explicitly: XLA clamps out-of-range (and NaN-derived) indices, torch
raises on them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sfm_mvs_tpu_torch.ops import pyramid
from sfm_mvs_tpu_torch.utils.device import resolve_device


class FlowResult(NamedTuple):
    points: torch.Tensor  # (N, 2) tracked positions in the next image
    valid: torch.Tensor  # (N,) bool: converged, in bounds, well-conditioned
    error: torch.Tensor  # (N,) mean absolute patch residual


def _sample_patch(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                  offs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of img (H, W) at (cx, cy) + offs: cx, cy (N,);
    offs (P, 2). Returns (N, P)."""
    H, W = img.shape
    x = torch.clamp(cx[:, None] + offs[:, 0], 0.0, W - 1.001)
    y = torch.clamp(cy[:, None] + offs[:, 1], 0.0, H - 1.001)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)
    base = y0 * W + x0
    return (flat[base] * (1 - fy) * (1 - fx)
            + flat[base + 1] * (1 - fy) * fx
            + flat[base + W] * fy * (1 - fx)
            + flat[base + W + 1] * fy * fx)


def track_points(img0, img1, pts0, valid0, levels: int = 3, window_radius: int = 7,
                 iterations: int = 10, min_eig: float = 1e-4, max_error: float = 0.15,
                 device="cuda") -> FlowResult:
    """Track pts0 from img0 into img1 (the cv2.calcOpticalFlowPyrLK slot).

    img0, img1: (H, W) float32 in [0, 1], tensors (their device is used) or
    numpy arrays (moved to `device`, default ``cuda``; without a GPU pass
    ``device="cpu"``); pts0: (N, 2) pixel coords; valid0: (N,) bool.
    Returns a FlowResult with positions in img1's frame.
    """
    if not isinstance(img0, torch.Tensor):
        dev = resolve_device(device)
        img0 = torch.as_tensor(np.asarray(img0, np.float32), device=dev)
        img1 = torch.as_tensor(np.asarray(img1, np.float32), device=dev)
    dev = img0.device
    pts0 = torch.as_tensor(pts0, dtype=torch.float32, device=dev)
    valid0 = torch.as_tensor(valid0, dtype=torch.bool, device=dev)
    H, W = img0.shape
    r = window_radius
    lin = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
    oy, ox = torch.meshgrid(lin, lin, indexing="ij")
    offs = torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)  # (P, 2)
    P = offs.shape[0]

    pyr0, pyr1 = [img0], [img1]
    for _ in range(levels - 1):
        pyr0.append(pyramid.pyr_down(pyr0[-1]))
        pyr1.append(pyramid.pyr_down(pyr1[-1]))

    N = pts0.shape[0]
    flow = torch.zeros((N, 2), dtype=torch.float32, device=dev)
    ok = torch.ones((N,), dtype=torch.bool, device=dev)
    err = torch.zeros((N,), dtype=torch.float32, device=dev)
    for lvl in range(levels - 1, -1, -1):
        i0, i1 = pyr0[lvl], pyr1[lvl]
        base = pts0 * (0.5 ** lvl)
        bx, by = base[:, 0], base[:, 1]
        # Template patch and its gradients from img0 at this level (fixed).
        t = _sample_patch(i0, bx, by, offs)
        gx = 0.5 * (_sample_patch(i0, bx + 1, by, offs) - _sample_patch(i0, bx - 1, by, offs))
        gy = 0.5 * (_sample_patch(i0, bx, by + 1, offs) - _sample_patch(i0, bx, by - 1, offs))
        a = (gx * gx).sum(-1)
        b = (gx * gy).sum(-1)
        c = (gy * gy).sum(-1)
        det = a * c - b * b
        trace = a + c
        eig_min = 0.5 * (trace - torch.sqrt(torch.clamp_min(trace * trace - 4 * det, 0.0)))
        cond_ok = eig_min / P > min_eig
        inv_det = torch.where(det.abs() < 1e-12, torch.zeros_like(det), 1.0 / det)
        for _ in range(iterations):
            q = base + flow
            d = _sample_patch(i1, q[:, 0], q[:, 1], offs) - t
            b1 = (gx * d).sum(-1)
            b2 = (gy * d).sum(-1)
            du = -(c * b1 - b * b2) * inv_det
            dv = -(-b * b1 + a * b2) * inv_det
            flow = flow + torch.stack([du, dv], dim=-1)
        ok = ok & cond_ok
        if lvl > 0:
            flow = flow * 2.0
        else:
            w = _sample_patch(i1, bx + flow[:, 0], by + flow[:, 1], offs)
            err = (w - t).abs().mean(-1)
    p1 = pts0 + flow
    inside = (p1[:, 0] >= r) & (p1[:, 0] < W - r) & (p1[:, 1] >= r) & (p1[:, 1] < H - r)
    return FlowResult(points=p1, valid=ok & inside & (err < max_error) & valid0, error=err)
