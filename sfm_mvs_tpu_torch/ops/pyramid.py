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


def replicate_pad(img: torch.Tensor, pad) -> torch.Tensor:
    """F.pad(..., mode="replicate") of the last two axes of (..., H, W)."""
    H, W = img.shape[-2:]
    out = F.pad(img.reshape(1, -1, H, W), pad, mode="replicate")
    return out.reshape(img.shape[:-2] + out.shape[-2:])


def _conv1d(img: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Separable conv along one spatial axis (0: rows, 1: columns) of
    (..., H, W), replicate padding."""
    radius = len(taps) // 2
    pad = (0, 0, radius, radius) if axis == 0 else (radius, radius, 0, 0)
    padded = replicate_pad(img, pad)
    H, W = img.shape[-2:]
    acc = None
    for t, k in enumerate(np.asarray(taps, dtype=np.float32)):
        sl = padded[..., t:t + H, :] if axis == 0 else padded[..., t:t + W]
        # add(alpha=) rounds once per tap (a fused multiply-add), as XLA's
        # CPU code for `acc + sl * k` does, and is one kernel per tap.
        acc = sl * float(k) if acc is None else acc.add(sl, alpha=float(k))
    return acc


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur. img: (..., H, W); sigma: Python float."""
    if sigma <= 0:
        return img
    taps = gaussian_kernel_1d(sigma)
    return _conv1d(_conv1d(img, taps, 0), taps, 1)


_PYR_TAPS = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Gaussian-pyramid downscale (cv2.pyrDown): 5-tap binomial blur with
    replicate padding, then 2x decimation. (H, W) -> ((H+1)//2, (W+1)//2)."""
    return _conv1d(_conv1d(img, _PYR_TAPS, 0), _PYR_TAPS, 1)[..., ::2, ::2]


def img_downscale(img: torch.Tensor, downscale: int) -> torch.Tensor:
    """Repeated pyr_down halvings, log2(downscale) of them: downscale in
    {1, 2, 4, 8, ...} (the reference's img_downscale, sfm.py:36-42)."""
    times = int(round(math.log2(int(downscale)))) if downscale > 1 else 0
    for _ in range(times):
        img = pyr_down(img)
    return img


def upsample2(img: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample (OpenCV SIFT's initial image doubling) of
    (..., H, W): interleave (x[i], (x[i] + x[i+1]) / 2) per axis, last row
    replicated."""

    def up_rows(x):
        mid = 0.5 * (x[..., :-1, :] + x[..., 1:, :])
        mid = torch.cat([mid, x[..., -1:, :]], dim=-2)
        H, W = x.shape[-2:]
        return torch.stack([x, mid], dim=-2).reshape(x.shape[:-2] + (2 * H, W))

    return up_rows(up_rows(img).transpose(-1, -2)).transpose(-1, -2)


def subsample2(img: torch.Tensor) -> torch.Tensor:
    """Every other pixel (between SIFT octaves; blur already applied)."""
    return img[..., ::2, ::2]


def gaussian_scale_space(img: torch.Tensor, sigma0: float = 1.6,
                         scales_per_octave: int = 3,
                         assumed_blur: float = 0.5) -> torch.Tensor:
    """One octave's Gaussian stack of img (..., H, W):
    (..., scales_per_octave + 3, H, W).

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
    return torch.stack(levels, dim=-3)
