"""Image pyramids: separable Gaussian blur, 2x upsample, subsample.

PyTorch port of ``sfm_mvs_tpu/ops/pyramid.py``. The blur is a
tap-unrolled shift-and-accumulate over an edge-padded copy, in the same
float32 order as the JAX package, and deliberately not ``conv2d``: a float32
convolution through cuDNN defaults to TF32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(sigma: float, radius: int | None = None) -> np.ndarray:
    """Normalized 1D Gaussian taps (host-side; sigma is a Python float)."""
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv1d(img: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Separable conv along one spatial axis of (H, W), replicate padding."""
    radius = len(taps) // 2
    pad = (0, 0, radius, radius) if axis == 0 else (radius, radius, 0, 0)
    padded = F.pad(img[None], pad, mode="replicate")[0]
    H, W = img.shape
    acc = None
    for t, k in enumerate(np.asarray(taps, dtype=np.float32)):
        sl = padded[t:t + H, :] if axis == 0 else padded[:, t:t + W]
        # add(alpha=) rounds once per tap (a fused multiply-add), as XLA's
        # CPU code for `acc + sl * k` does, and is one kernel per tap.
        acc = sl * float(k) if acc is None else acc.add(sl, alpha=float(k))
    return acc


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur. img: (H, W); sigma: Python float."""
    if sigma <= 0:
        return img
    taps = gaussian_kernel_1d(sigma)
    return _conv1d(_conv1d(img, taps, 0), taps, 1)


def upsample2(img: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample (OpenCV SIFT's initial image doubling):
    interleave (x[i], (x[i] + x[i+1]) / 2) per axis, last row replicated."""

    def up_axis0(x):
        mid = 0.5 * (x[:-1, :] + x[1:, :])
        mid = torch.cat([mid, x[-1:, :]], dim=0)
        return torch.stack([x, mid], dim=1).reshape(2 * x.shape[0], x.shape[1])

    return up_axis0(up_axis0(img).T).T


def subsample2(img: torch.Tensor) -> torch.Tensor:
    """Every other pixel (between SIFT octaves; blur already applied)."""
    return img[::2, ::2]


def gaussian_scale_space(img: torch.Tensor, sigma0: float = 1.6,
                         scales_per_octave: int = 3,
                         assumed_blur: float = 0.5) -> torch.Tensor:
    """One octave's Gaussian stack: (scales_per_octave + 3, H, W).

    img carries `assumed_blur`; level i is brought to sigma0 * 2^(i/S) by
    incremental blurs.
    """
    S = scales_per_octave
    k = 2.0 ** (1.0 / S)
    sig_prev = assumed_blur
    levels = []
    cur = img
    for i in range(S + 3):
        sig_total = sigma0 * (k ** i)
        sig_diff = math.sqrt(max(sig_total ** 2 - sig_prev ** 2, 1e-8))
        cur = gaussian_blur(cur, sig_diff)
        levels.append(cur)
        sig_prev = sig_total
    return torch.stack(levels)
