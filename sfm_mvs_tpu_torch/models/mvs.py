"""Multi-view stereo densification: plane-sweep depth maps + fusion.

PyTorch port of ``sfm_mvs_tpu/models/mvs.py``:

- For each reference frame, a coarse-to-fine plane sweep over inverse-depth
  hypotheses: every neighbor image is warped onto the reference through
  the plane-induced mapping and compared with a locally normalized
  photometric cost (box filter of the neighbor-aggregated absolute
  difference, as differences of float32 cumulative sums).
- Depth = argmin over the hypotheses (the first on ties) with parabolic
  sub-step refinement, filtered by photometric confidence.
- Pass 2 checks every depth against the neighbors' depth maps (agreement
  vote, free-space veto, confidence floor, near-side edge trim), fuses the
  agreeing depths and back-projects the survivors into a colored cloud.

The JAX package vmaps over reference frames and maps over hypotheses one
after another (``jax.lax.map``) to bound memory. Here the functions carry
an explicit leading batch axis of reference frames. On CUDA tensors pass
1 runs two hand-written kernels (``ops/mvs_cuda.py``,
``csrc/mvs_sweep.cu``), one launch each a pyramid level: the zero-mean
filter of the references and neighbours, and the sweep over all the
level's hypotheses. On CPU tensors it runs the plain code
(:func:`_zero_mean_plain`, :func:`_sweep_select_plain`): the hypotheses
in a Python loop, each building its (B, M, H*W, 3) warp, in the JAX
package's summation order. The JAX package leaves all of this to XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sfm_mvs_tpu_torch.models.map_store import MapState
from sfm_mvs_tpu_torch.ops import mvs_cuda
from sfm_mvs_tpu_torch.ops import projection as proj
from sfm_mvs_tpu_torch.parallel import mesh as meshlib
from sfm_mvs_tpu_torch.utils import profiling

# torch.nanquantile refuses inputs of more than 2**24 elements; the
# per-camera depth quantiles run over row chunks below that size.
_QUANTILE_MAX_ELEMS = 1 << 24


class DepthMap(NamedTuple):
    depth: torch.Tensor  # (..., H, W) metric depth in the reference frame
    confidence: torch.Tensor  # (..., H, W) in [0, 1]
    valid: torch.Tensor  # (..., H, W) bool


def _flat_gather(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """img (..., H, W), idx (..., P) flat pixel indices -> (..., P)."""
    return torch.gather(img.reshape(img.shape[:-2] + (-1,)), -1, idx)


def _bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Sample img (..., H, W) at float coords x, y (..., P); returns
    (values, inside_mask)."""
    H, W = img.shape[-2:]
    inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    base = y0.long() * W + x0.long()
    v = (_flat_gather(img, base) * (1 - fy) * (1 - fx)
         + _flat_gather(img, base + 1) * (1 - fy) * fx
         + _flat_gather(img, base + W) * fy * (1 - fx)
         + _flat_gather(img, base + W + 1) * fy * fx)
    return v, inside


def _nearest_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """1-tap nearest sample (round half to even, as jnp.round)."""
    H, W = img.shape[-2:]
    inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    ix = torch.clamp(torch.round(x).long(), 0, W - 1)
    iy = torch.clamp(torch.round(y).long(), 0, H - 1)
    return _flat_gather(img, iy * W + ix), inside


def _edge_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """Replicate-pad the last two axes of (..., H, W) by r."""
    lead = x.shape[:-2]
    y = F.pad(x.reshape((-1, 1) + x.shape[-2:]), (r, r, r, r), mode="replicate")
    return y.reshape(lead + y.shape[-2:])


def _cumsum(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """float32 cumulative sum along the last axis in XLA's order: sequential
    sums inside blocks of `block`, plus the exclusive prefix of the block
    totals (computed the same way, recursively). jnp.cumsum on the CPU sums
    in exactly this order, so the results agree bitwise (torch.cumsum
    accumulates in double on the CPU and in a parallel scan on CUDA)."""
    n = x.shape[-1]
    nb = -(-n // block)
    if nb > 1:
        x = F.pad(x, (0, nb * block - n)).reshape(x.shape[:-1] + (nb, block))
    out = x.clone()
    for k in range(1, out.shape[-1]):
        out[..., k] += out[..., k - 1]
    if nb == 1:
        return out
    prefix = _cumsum(out[..., -1], block)
    out[..., 1:, :] += prefix[..., :-1, None]
    return out.reshape(out.shape[:-2] + (nb * block,))[..., :n]


def _box_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable box filter over the last two axes, as differences of
    float32 cumulative sums over an edge-padded copy (the JAX package's
    form and summation order, so the rounding agrees; no convolution)."""
    k = 2 * radius + 1
    c = _cumsum(_edge_pad(x, radius))
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    x1 = (c[..., k:] - c[..., :-k]) / k
    c = _cumsum(x1.transpose(-1, -2)).transpose(-1, -2)
    c = torch.cat([torch.zeros_like(c[..., :1, :]), c], dim=-2)
    return (c[..., k:, :] - c[..., :-k, :]) / k


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x average-pool over the last two axes (crops odd trailing row/col)."""
    H2, W2 = img.shape[-2] // 2, img.shape[-1] // 2
    x = img[..., : H2 * 2, : W2 * 2].reshape(img.shape[:-2] + (H2, 2, W2, 2))
    return x.mean(dim=(-3, -1))


def _scale_K(K: torch.Tensor, s: float) -> torch.Tensor:
    """Intrinsics for an image downsampled by factor s (pixel centers at
    integer coords: x_l = (x + 0.5)/s - 0.5)."""
    S = torch.tensor([[1.0 / s, 0.0, 0.5 / s - 0.5],
                      [0.0, 1.0 / s, 0.5 / s - 0.5],
                      [0.0, 0.0, 1.0]], dtype=K.dtype, device=K.device)
    return S @ K


def _pool3(x: torch.Tensor, op) -> torch.Tensor:
    """3x3 min/max pool (op = torch.minimum / torch.maximum) over the last
    two axes, SAME padding with a -inf/+inf border (reduce_window's)."""
    lead = x.shape[:-2]
    y = x.reshape((-1,) + x.shape[-2:])
    if op is torch.minimum:
        y = -F.max_pool2d(-y, 3, 1, 1)
    else:
        y = F.max_pool2d(y, 3, 1, 1)
    return y.reshape(lead + y.shape[-2:])


def _resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """jax.image.resize(..., "linear") for upsampling: half-pixel-centre
    bilinear with the border taps clamped. x: (B, H, W)."""
    return F.interpolate(x[:, None], size=tuple(size), mode="bilinear",
                         align_corners=False)[:, 0]


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """(B, num) rows from start to stop, with jnp.linspace's formula
    start * (1 - s) + stop * s, s = i / (num - 1), the last entry stop."""
    if num == 1:
        return start[:, None]
    s = torch.arange(num - 1, dtype=start.dtype, device=start.device) / float(num - 1)
    out = start[:, None] * (1 - s) + stop[:, None] * s
    return torch.cat([out, stop[:, None]], dim=1)


def _inv_K(K: torch.Tensor) -> torch.Tensor:
    """Inverse of a zero-skew intrinsic matrix in closed form,
    [[1/fx, 0, -cx (1/fx)], [0, 1/fy, -cy (1/fy)], [0, 0, 1]]: the values
    jnp.linalg.inv returns for it, bit for bit (torch.linalg.inv rounds
    the last column differently, which shifts every ray)."""
    ifx, ify = 1.0 / K[0, 0], 1.0 / K[1, 1]
    zero, one = torch.zeros_like(ifx), torch.ones_like(ifx)
    return torch.stack([torch.stack([ifx, zero, -(K[0, 2] * ifx)]),
                        torch.stack([zero, ify, -(K[1, 2] * ify)]),
                        torch.stack([zero, zero, one])])


def _pixel_rays(H: int, W: int, K: torch.Tensor, dist=None, stride: int = 1) -> torch.Tensor:
    """(h, w, 3) ideal camera rays (z = 1) of the pixel grid, every
    `stride`-th pixel; `dist` = (k1, k2) undistorts them."""
    ys, xs = torch.meshgrid(torch.arange(0, H, stride, dtype=K.dtype, device=K.device),
                            torch.arange(0, W, stride, dtype=K.dtype, device=K.device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    rays = pix @ _inv_K(K).T
    if dist is not None:
        xy_u = proj.undistort_normalized(rays[..., :2], dist)
        rays = torch.cat([xy_u, torch.ones_like(rays[..., 2:])], dim=-1)
    return rays


def _zero_mean(refs: torch.Tensor, nbrs: torch.Tensor, radius: int):
    """(refs, nbrs) minus their box filters of `radius`: refs (B, H, W),
    nbrs (B, M, H, W). One kernel launch on CUDA tensors, the plain code on
    CPU tensors."""
    if refs.device.type == "cpu":
        return _zero_mean_plain(refs, nbrs, radius)
    return mvs_cuda.zero_mean(refs, nbrs, radius)


def _zero_mean_plain(refs: torch.Tensor, nbrs: torch.Tensor, radius: int):
    return refs - _box_filter(refs, radius), nbrs - _box_filter(nbrs, radius)


def _sweep_select(ref_zm, nbrs_zm, Kl, R_rel, t_rel, center, offsets, cost_radius,
                  dist=None, sample_mode="bilinear", extra=()):
    """Evaluate per-pixel inverse-depth hypotheses `center + offsets[d]`
    (then the per-pixel maps in `extra`) and select the best with
    parabolic sub-step refinement over the uniform ones.

    ref_zm (B, H, W), nbrs_zm (B, M, H, W), R_rel (B, M, 3, 3), t_rel
    (B, M, 3), center (B, H, W), offsets (B, D), extra: (B, H, W) maps; or
    the same without the batch axis. The warped neighbor point of a
    reference pixel with ray r at inverse depth iv is R_rel r + t_rel iv.
    Returns (invd_map, best_cost, mean_cost, den_at_best).

    CUDA tensors take the sweep kernel (``mvs_cuda.sweep_select``, one
    launch); CPU tensors take :func:`_sweep_select_plain`.
    """
    if ref_zm.dim() == 2:
        out = _sweep_select(ref_zm[None], nbrs_zm[None], Kl, R_rel[None], t_rel[None],
                            center[None], offsets[None], cost_radius, dist=dist,
                            sample_mode=sample_mode, extra=tuple(e[None] for e in extra))
        return tuple(o[0] for o in out)
    if ref_zm.device.type == "cpu":
        return _sweep_select_plain(ref_zm, nbrs_zm, Kl, R_rel, t_rel, center, offsets,
                                   cost_radius, dist=dist, sample_mode=sample_mode, extra=extra)
    return mvs_cuda.sweep_select(ref_zm, nbrs_zm, Kl, R_rel, t_rel, center, offsets, cost_radius,
                                 dist=dist, sample_mode=sample_mode, extra=extra)


def _sweep_select_plain(ref_zm, nbrs_zm, Kl, R_rel, t_rel, center, offsets, cost_radius,
                        dist=None, sample_mode="bilinear", extra=()):
    """:func:`_sweep_select` in plain PyTorch, batched inputs only: one
    chain of ops per hypothesis, in the JAX package's summation order. Any
    device and float dtype (the kernel's check on the card runs it in
    float64)."""
    B, H, W = ref_zm.shape
    rays = _pixel_rays(H, W, Kl, dist).reshape(-1, 3)  # (HW, 3)
    a = torch.einsum("bmij,pj->bmpi", R_rel, rays)  # (B, M, HW, 3)
    hv = t_rel[:, :, None, :]  # (B, M, 1, 3)
    fx, fy, cx, cy = Kl[0, 0], Kl[1, 1], Kl[0, 2], Kl[1, 2]
    ref_flat = ref_zm.reshape(B, 1, -1)
    sampler = _nearest_sample if sample_mode == "nearest" else _bilinear_sample

    def cost_one(iv_map):
        # (B, M, HW) warped camera point a + hv * iv. XLA's CPU code fuses
        # the x, y rows and the pixel affine into multiply-adds (addcmul
        # rounds once, as they do) and keeps z's two roundings; matching
        # them keeps nearest taps and near-tied costs on XLA's side.
        iv = iv_map.reshape(B, 1, -1)
        qx = torch.addcmul(a[..., 0], hv[..., 0], iv)
        qy = torch.addcmul(a[..., 1], hv[..., 1], iv)
        z = a[..., 2] + hv[..., 2] * iv
        zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        xn = qx / zs
        yn = qy / zs
        if dist is not None:
            xy_d = proj.distort_normalized(torch.stack([xn, yn], dim=-1), dist)
            xn, yn = xy_d[..., 0], xy_d[..., 1]
        vals, inside = sampler(nbrs_zm, torch.addcmul(cx, xn, fx),
                               torch.addcmul(cy, yn, fy))  # (B, M, HW)
        w = (inside & (z > 1e-6)).to(ref_zm.dtype)
        num = ((vals - ref_flat).abs() * w).sum(1)
        den = w.sum(1)
        num_f = _box_filter(num.reshape(B, H, W), cost_radius)
        den_f = _box_filter(den.reshape(B, H, W), cost_radius)
        cost = torch.where(den_f > 1e-6, num_f / torch.clamp_min(den_f, 1e-6),
                           torch.ones_like(num_f))
        return cost, den.reshape(B, H, W)

    # Hypothesis stack: D uniform steps around `center`, then the `extra`
    # per-pixel maps (escape hypotheses: the 3x3 min/max-pooled coarse
    # inverse depth, which lets a pixel mis-assigned at a depth edge jump
    # to the adjacent surface). One hypothesis at a time bounds memory.
    D = offsets.shape[1]
    hyps = center[:, None] + offsets[:, :, None, None]  # (B, D, H, W)
    if extra:
        hyps = torch.cat([hyps, torch.stack(list(extra), dim=1)], dim=1)
    costs, dens = zip(*[cost_one(hyps[:, d]) for d in range(hyps.shape[1])])
    costs = torch.stack(costs, dim=1)  # (B, D+E, H, W)
    dens = torch.stack(dens, dim=1)

    # Parabolic sub-step refinement over the uniform subset.
    cu = costs[:, :D]
    best_u = torch.argmin(cu, dim=1)
    bc_u = cu.min(dim=1).values
    c0 = torch.gather(cu, 1, torch.clamp(best_u - 1, 0, D - 1)[:, None])[:, 0]
    c2 = torch.gather(cu, 1, torch.clamp(best_u + 1, 0, D - 1)[:, None])[:, 0]
    denom = c0 - 2 * bc_u + c2
    shift = torch.where(denom.abs() < 1e-9, torch.zeros_like(denom), 0.5 * (c0 - c2) / denom)
    shift = torch.clamp(shift, -1.0, 1.0)
    step = (offsets[:, 1] - offsets[:, 0] if D > 1 else torch.zeros_like(offsets[:, 0]))
    off_best = torch.gather(offsets, 1, best_u.reshape(B, -1)).reshape(B, H, W)
    invd_u = center + off_best + shift * step[:, None, None]

    best_all = torch.argmin(costs, dim=1)
    best_cost = costs.min(dim=1).values
    invd = torch.where(best_all < D, invd_u,
                       torch.gather(hyps, 1, best_all[:, None])[:, 0])
    mean_cost = cu.mean(dim=1)
    den_best = torch.gather(dens, 1, best_all[:, None])[:, 0]
    return invd, best_cost, mean_cost, den_best


def _plane_sweep_batch(ref_b, nbr_b, pose_b, nposes_b, K, lo_b, hi_b, num_depths: int = 64,
                       cost_radius: int = 2, min_confidence: float = 0.15,
                       coarse_levels: int = 2, refine_hyps: int = 5,
                       refine_hyps_final: int = 3, escape_final: bool = True,
                       dist=None) -> DepthMap:
    """Coarse-to-fine plane sweep for a batch of reference frames.

    ref_b (B, H, W), nbr_b (B, M, H, W), pose_b (B, 3, 4), nposes_b
    (B, M, 3, 4) world->cam, lo_b/hi_b (B,) depth range. The full
    `num_depths` sweep runs at 1/2^coarse_levels resolution with nearest
    taps; each finer level re-searches `refine_hyps` (at the finest,
    `refine_hyps_final`) half-size steps around the upsampled inverse depth,
    plus the two pooled escape hypotheses. Confidence is the coarse
    sweep's peakedness (best vs mean cost), upsampled.
    """
    R_ref, t_ref = pose_b[:, :, :3], pose_b[:, :, 3]
    R_n, t_n = nposes_b[..., :3], nposes_b[..., 3]
    R_rel = torch.einsum("bmij,bkj->bmik", R_n, R_ref).contiguous()  # (B, M, 3, 3)
    t_rel = t_n - torch.einsum("bmij,bj->bmi", R_rel, t_ref)  # (B, M, 3)

    # Pyramids, zero-meaned per level in each image's own frame.
    refs, nbrs = [ref_b], [nbr_b]
    for _ in range(coarse_levels):
        refs.append(_downsample2(refs[-1]))
        nbrs.append(_downsample2(nbrs[-1]))
    refs_zm, nbrs_zm = zip(*[_zero_mean(r, n, cost_radius) for r, n in zip(refs, nbrs)])

    inv_lo = 1.0 / hi_b
    inv_hi = 1.0 / lo_b
    L = coarse_levels
    invd, best_c, mean_c, den_b = _sweep_select(
        refs_zm[L], nbrs_zm[L], _scale_K(K, float(2 ** L)), R_rel, t_rel,
        torch.zeros_like(refs_zm[L]), _linspace(inv_lo, inv_hi, num_depths), cost_radius,
        dist=dist, sample_mode="nearest")
    conf = torch.clamp((mean_c - best_c) / torch.clamp_min(mean_c, 1e-6), 0.0, 1.0)
    step = (inv_hi - inv_lo) / max(num_depths - 1, 1)

    for lev in range(L - 1, -1, -1):
        size = refs_zm[lev].shape[-2:]
        # Pool BEFORE upsampling: a 3x3 pool at the coarser grid reaches one
        # full coarse pixel (the fattening-band scale).
        lo = _resize_linear(_pool3(invd, torch.minimum), size)
        hi = _resize_linear(_pool3(invd, torch.maximum), size)
        invd = _resize_linear(invd, size)
        conf = _resize_linear(conf, size)
        step = step * 0.5
        nh, escape = refine_hyps, (lo, hi)
        if lev == 0 and refine_hyps_final > 0:
            nh = refine_hyps_final
            if escape_final is False:
                escape = ()
        offs = (torch.arange(nh, dtype=invd.dtype, device=invd.device) - (nh - 1) / 2.0
                )[None, :] * step[:, None]
        invd, best_c, _, den_b = _sweep_select(
            refs_zm[lev], nbrs_zm[lev], _scale_K(K, float(2 ** lev)), R_rel, t_rel,
            invd, offs, cost_radius, dist=dist, extra=escape)

    invd = torch.clamp(invd, (inv_lo * 0.5)[:, None, None], (inv_hi * 2.0)[:, None, None])
    depth = 1.0 / torch.clamp_min(invd, 1e-6)
    valid = (conf > min_confidence) & (den_b > 0.5)
    return DepthMap(depth=depth, confidence=conf, valid=valid)


def plane_sweep_depth(ref_img, nbr_imgs, pose_ref, nbr_poses, K, min_depth, max_depth,
                      num_depths: int = 64, cost_radius: int = 2,
                      min_confidence: float = 0.15, coarse_levels: int = 2,
                      refine_hyps: int = 5, refine_hyps_final: int = 3,
                      escape_final: bool = True, dist=None) -> DepthMap:
    """Coarse-to-fine plane-sweep stereo for one reference frame.

    ref_img: (H, W) grayscale; nbr_imgs: (M, H, W); pose_*: world->cam
    [R|t]; min_depth/max_depth: the depth range (0-dim tensors or floats).
    """
    dt, dev = ref_img.dtype, ref_img.device
    rng = [torch.as_tensor(v, dtype=dt, device=dev).reshape(1) for v in (min_depth, max_depth)]
    dm = _plane_sweep_batch(ref_img[None], nbr_imgs[None], pose_ref[None], nbr_poses[None],
                            K, rng[0], rng[1], num_depths=num_depths, cost_radius=cost_radius,
                            min_confidence=min_confidence, coarse_levels=coarse_levels,
                            refine_hyps=refine_hyps, refine_hyps_final=refine_hyps_final,
                            escape_final=escape_final, dist=dist)
    return DepthMap(*[x[0] for x in dm])


def _backproject(depth, valid, pose, K, color, stride: int, dist, gray: bool):
    """Batched back-projection: depth/valid (B, H, W), pose (B, 3, 4),
    color (B, H, W[, 3]) or None. Returns (B, N, 3), (B, N, 3), (B, N)."""
    B, H, W = depth.shape
    rays = _pixel_rays(H, W, K, dist, stride)  # (h, w, 3)
    d = depth[:, ::stride, ::stride]
    Xc = rays * d[..., None]
    R, t = pose[:, :, :3], pose[:, :, 3]
    Xw = (Xc - t[:, None, None, :]) @ R[:, None]  # R^T (Xc - t)
    if color is None:
        c = torch.full_like(Xw, 200.0)
    elif gray:
        c = color[:, ::stride, ::stride][..., None] * torch.ones(3, dtype=Xw.dtype,
                                                                device=Xw.device)
        c = c * 255.0
    else:
        c = color[:, ::stride, ::stride]
    return Xw.reshape(B, -1, 3), c.reshape(B, -1, 3), valid[:, ::stride, ::stride].reshape(B, -1)


def backproject_depth(dm: DepthMap, pose_ref, K, color_img=None, stride: int = 2, dist=None):
    """Depth map -> world points (+BGR colors). Returns (pts (N,3), colors,
    valid) with N = ceil(H/stride)*ceil(W/stride). A (H, W) color image is
    gray in [0, 1]; `dist` = (k1, k2) undistorts the pixel rays."""
    color = None if color_img is None else color_img[None]
    gray = color_img is not None and color_img.dim() == 2
    out = _backproject(dm.depth[None], dm.valid[None], pose_ref[None], K, color, stride,
                       dist, gray)
    return tuple(o[0] for o in out)


def geometric_consistency(dm_ref: DepthMap, pose_ref, dm_nbrs_depth, nbr_poses, K,
                          rel_tol: float = 0.03, min_consistent=1, dist=None,
                          nbr_valid=None, fuse_depths: bool = True,
                          edge_trim_rel: float = 0.0, edge_trim_radius: int = 2,
                          free_space_rel: float = 0.05, edge_keep_conf: float = 0.75,
                          min_conf: float = 0.0) -> DepthMap:
    """Cross-view depth-consistency filter and multi-view depth fusion.

    dm_ref (..., H, W) fields, pose_ref (..., 3, 4), dm_nbrs_depth
    (..., M, H, W), nbr_poses (..., M, 3, 4), nbr_valid (..., M) (padded
    neighbor slots do not vote), min_consistent an int or (...,) tensor.
    Each reference pixel is back-projected at its depth and projected into
    every neighbor, whose depth map is read there (nearest tap):

    - agreement within `rel_tol` relative depth by >= `min_consistent`
      neighbors keeps the pixel;
    - free_space_rel > 0: a neighbor whose surface lies more than that
      (relative) BEHIND the point sees through it, and the pixel drops;
    - min_conf > 0: pixels of lower photometric confidence drop;
    - fuse_depths: survivors take the mean of their depth and every
      agreeing neighbor's implied depth;
    - edge_trim_rel > 0: pixels on the near side of a depth jump (local
      max-min over a (2*radius+1)^2 window above `edge_trim_rel * depth`)
      drop, unless their confidence exceeds `edge_keep_conf`.
    """
    depth, conf = dm_ref.depth, dm_ref.confidence
    H, W = depth.shape[-2:]
    Xc = _pixel_rays(H, W, K, dist) * depth[..., None]
    R, t = pose_ref[..., :3], pose_ref[..., 3]
    Xw = (Xc - t[..., None, None, :]) @ R[..., None, :, :]  # (..., H, W, 3)
    Rn, tn = nbr_poses[..., :3], nbr_poses[..., 3]
    Xn = Xw[..., None, :, :, :] @ Rn.transpose(-1, -2)[..., None, :, :] + tn[..., None, None, :]
    z = Xn[..., 2]  # (..., M, H, W)
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    xn = Xn[..., 0] / zs
    yn = Xn[..., 1] / zs
    if dist is not None:
        xy_d = proj.distort_normalized(torch.stack([xn, yn], dim=-1), dist)
        xn, yn = xy_d[..., 0], xy_d[..., 1]
    u = xn * K[0, 0] + K[0, 2]
    v = yn * K[1, 1] + K[1, 2]
    # Nearest depth lookup: bilinear would blend across the neighbor's own
    # depth discontinuities into mid-air values.
    sampled, inside = _nearest_sample(dm_nbrs_depth, u.flatten(-2), v.flatten(-2))
    sampled = sampled.reshape(z.shape)
    inside = inside.reshape(z.shape)
    front = inside & (z > 0)
    agree = front & ((sampled - z).abs() < rel_tol * torch.clamp_min(z, 1e-6))
    violate = front & (sampled > z * (1.0 + free_space_rel))
    # Implied reference depth: where our ray meets the neighbor's surface.
    z_imp = depth[..., None, :, :] * (sampled / torch.clamp_min(z, 1e-6))
    if nbr_valid is not None:
        agree = agree & nbr_valid[..., None, None]
        violate = violate & nbr_valid[..., None, None]
    n_agree = agree.to(torch.int32).sum(-3)
    min_cons = torch.as_tensor(min_consistent, device=depth.device)
    valid = dm_ref.valid & (n_agree >= min_cons.reshape(min_cons.shape + (1, 1)))
    if free_space_rel > 0.0:
        valid = valid & ~violate.any(-3)
    if min_conf > 0.0:
        valid = valid & (conf > min_conf)
    if fuse_depths:
        fused = (depth + (z_imp * agree.to(depth.dtype)).sum(-3)) / (
            1.0 + n_agree.to(depth.dtype))
        depth = torch.where(valid, fused, depth)
    if edge_trim_rel > 0.0:
        dmax = depth
        dmin = depth
        for _ in range(edge_trim_radius):
            dmax = _pool3(dmax, torch.maximum)
            dmin = _pool3(dmin, torch.minimum)
        jump = (dmax - dmin) > edge_trim_rel * torch.clamp_min(depth, 1e-6)
        # Asymmetric: only the near-depth plateau beside a jump carries the
        # foreground-fattening halo; high-confidence pixels there are kept.
        near_side = depth < dmin * (1.0 + edge_trim_rel)
        rescue = conf > edge_keep_conf
        valid = valid & ~(jump & near_side & ~rescue)
    return DepthMap(depth=depth, confidence=conf, valid=valid)


def _fuse_batch(depth_b, conf_b, valid_b, pose_b, nbr_depth_b, nbr_pose_b, nbr_valid_b,
                min_cons_b, K, color_b, rel_tol, stride: int = 2,
                geometric_check: bool = True, dist=None, fuse_depths: bool = True,
                edge_trim_rel: float = 0.0, free_space_rel: float = 0.05,
                edge_trim_radius: int = 2, edge_keep_conf: float = 0.75,
                min_conf: float = 0.0, gray: Optional[bool] = None):
    """Geometric consistency + back-projection for a batch of reference
    frames. Returns (pts, cols, ok, valid, depth), the last two the
    filtered and fused depth maps. color_b: (B, H, W, 3) BGR or (B, H, W)
    gray in [0, 1]."""
    dm = DepthMap(depth=depth_b, confidence=conf_b, valid=valid_b)
    if geometric_check:
        dm = geometric_consistency(
            dm, pose_b, nbr_depth_b, nbr_pose_b, K, rel_tol=rel_tol,
            min_consistent=min_cons_b, dist=dist, nbr_valid=nbr_valid_b,
            fuse_depths=fuse_depths, edge_trim_rel=edge_trim_rel,
            free_space_rel=free_space_rel, edge_trim_radius=edge_trim_radius,
            edge_keep_conf=edge_keep_conf, min_conf=min_conf)
    if gray is None:
        gray = color_b.dim() == 3
    pts, cols, ok = _backproject(dm.depth, dm.valid, pose_b, K, color_b, stride, dist, gray)
    return pts, cols, ok, dm.valid, dm.depth


def _depth_ranges(state: MapState):
    """Per-camera (min_depth, max_depth) from the sparse cloud: the 2%/98%
    quantiles of the positive point depths per camera, widened by
    0.7x/1.4x (1.0/10.0 where a camera sees no point)."""
    R = state.poses[:, :, :3]
    t = state.poses[:, :, 3]
    z = torch.einsum("pj,cj->cp", state.points, R[:, 2]) + t[:, 2:3].reshape(-1, 1)
    ok = state.point_valid[None, :] & (z > 0)
    zq = torch.where(ok, z, torch.full_like(z, float("nan")))
    rows = max(1, _QUANTILE_MAX_ELEMS // max(zq.shape[1], 1))
    q = torch.tensor([0.02, 0.98], dtype=z.dtype, device=z.device)
    lohi = torch.cat([torch.nanquantile(zq[s:s + rows], q, dim=1)
                      for s in range(0, zq.shape[0], rows)], dim=1)
    lo = torch.where(torch.isnan(lohi[0]), torch.ones_like(lohi[0]), lohi[0])
    hi = torch.where(torch.isnan(lohi[1]), torch.full_like(lohi[1], 10.0), lohi[1])
    return lo * 0.7, hi * 1.4


def _stage(images, n: int, device) -> list:
    return [torch.as_tensor(np.asarray(g, np.float32), device=device)
            if not isinstance(g, torch.Tensor) else g.to(device=device, dtype=torch.float32)
            for g in images[:n]]


def densify_map(images_gray: Sequence, state: MapState, num_depths: int = 64,
                num_neighbors: int = 2, stride: int = 2,
                images_bgr: Optional[Sequence] = None, geometric_check: bool = True,
                geo_rel_tol: float = 0.015, geo_min_consistent: int = 2,
                fuse_depths: bool = True, edge_trim_rel: float = 0.06,
                edge_trim_radius: int = 6, edge_keep_conf: float = 0.75,
                free_space_rel: float = 0.05, geo_num_neighbors: int = 4,
                min_conf: float = 0.0, batch: int = 4, mesh=None,
                return_depth_maps: bool = False, dist=None,
                max_refs: Optional[int] = None):
    """Plane-sweep every frame, cross-check depths, fuse a colored cloud.

    Pass 1 plane-sweeps depth maps in batches of `batch` reference frames
    (the ±`num_neighbors` frames as neighbors; depth ranges from the sparse
    map). Pass 2 runs the geometric-consistency filter against the wider
    ±`geo_num_neighbors` window (their depth maps already exist) and
    back-projects the survivors. Images (numpy arrays or tensors) are
    staged on the map's device. max_refs sweeps only the first max_refs
    reference frames (neighbor selection still uses every camera).

    With `mesh` (a ``parallel.mesh.Mesh`` or a process group, every rank
    calling with the same arguments), `batch` is rounded up to a multiple of
    the rank count and each rank sweeps its slots of every pass-1 batch;
    an all-gather of depth, confidence and valid gives every rank all the
    depth maps, and pass 2 runs on every rank as in the unsharded run, so
    every rank returns the same cloud.

    Returns (points (N, 3), colors (N, 3)) as float32 numpy arrays, ready
    for io.to_ply, and with `return_depth_maps` also {frame: DepthMap} of
    the filtered, fused depth maps.

    Traced as the span ``mvs`` (counter ``mvs.views``, the reference views)
    with the children ``mvs.ranges`` (the depth ranges), ``mvs.stage`` (the
    images to the device), ``mvs.sweep`` (one per pass-1 chunk),
    ``mvs.fuse`` (one per pass-2 chunk) and ``mvs.copy`` (the chunk's cloud
    to the host).
    """
    with profiling.span("mvs"):
        if mesh is not None:
            mesh = meshlib.as_mesh(mesh)
            batch = -(-max(batch, mesh.size) // mesh.size) * mesh.size
            mine = meshlib.block(batch, mesh)
        n_total = int(state.num_cams)
        n_cams = n_total if max_refs is None else min(n_total, max_refs)
        K = state.K
        dev = K.device

        def neighbors(r, hi=n_total, k=None):
            k = num_neighbors if k is None else k
            return [i for i in range(max(0, r - k), min(hi, r + k + 1)) if i != r]

        geo_k = max(num_neighbors, geo_num_neighbors)
        profiling.count("mvs.views", n_cams)
        with profiling.span("mvs.ranges"):
            lo_all, hi_all = _depth_ranges(state)
        # Pass 1 warps neighbor IMAGES (full-set neighbors reach past the swept
        # refs); stage only the frames actually touched.
        with profiling.span("mvs.stage"):
            imgs_dev = _stage(images_gray, min(n_total, n_cams + num_neighbors), dev)
        M = max(len(neighbors(r)) for r in range(n_total))

        # Pass 1: depth maps, one batched sweep per chunk of refs.
        depth_maps: dict[int, DepthMap] = {}
        refs = list(range(n_cams))
        for s in range(0, len(refs), batch):
            chunk = refs[s:s + batch]
            chunk_p = chunk + [chunk[-1]] * (batch - len(chunk))
            # Pad each ref's neighbor list to M by repeating its first neighbor
            # (a duplicated view only re-votes the same evidence).
            nbr_idx = [(neighbors(r) + [neighbors(r)[0]] * M)[:M] for r in chunk_p]
            if mesh is not None:  # this rank's slots of the batch
                chunk_p, nbr_idx = chunk_p[mine], nbr_idx[mine]
            with profiling.span("mvs.sweep"):
                idx = torch.as_tensor(chunk_p, device=dev)
                dms = _plane_sweep_batch(
                    torch.stack([imgs_dev[r] for r in chunk_p]),
                    torch.stack([torch.stack([imgs_dev[i] for i in nn]) for nn in nbr_idx]),
                    state.poses[idx], state.poses[torch.as_tensor(nbr_idx, device=dev)], K,
                    lo_all[idx], hi_all[idx], num_depths=num_depths, dist=dist)
                if mesh is not None:  # every rank's slots, in slot order
                    dms = DepthMap(*[meshlib.all_gather(x, mesh).flatten(0, 1) for x in dms])
            for j, r in enumerate(chunk):
                depth_maps[r] = DepthMap(*[x[j] for x in dms])

        # Pass 2: cross-view consistency + fusion, in chunks of `batch` refs,
        # the pass-1 chunk. Each ref's check holds ~15 float planes per
        # neighbor (2 * geo_k of them), so a chunk of 4 at 968x648 holds
        # 4 * 8 * 15 planes of 2.5 MB, ~1.2 GB: far inside an 80 GB card. The
        # JAX package caps this chunk at 2 for a v5e fault that does not
        # apply here.
        M2 = 2 * geo_k
        depth_stack = torch.stack([depth_maps[r].depth for r in refs])
        conf_stack = torch.stack([depth_maps[r].confidence for r in refs])
        valid_stack = torch.stack([depth_maps[r].valid for r in refs])
        colors = images_bgr if images_bgr is not None else images_gray
        with profiling.span("mvs.stage"):
            colors_dev = _stage(colors, n_cams, dev)
        gray = images_bgr is None
        all_pts, all_cols = [], []
        filtered: dict[int, DepthMap] = {}
        for s in range(0, len(refs), batch):
            chunk = refs[s:s + batch]
            chunk_p = chunk + [chunk[-1]] * (batch - len(chunk))
            # Neighbor DEPTH MAPS exist only for swept refs; padded slots are
            # masked out of the vote by nbr_valid.
            nbrs_l = [[i for i in neighbors(r, k=geo_k) if i < n_cams] for r in chunk_p]
            nbr_idx = [((nn or [r]) + [(nn or [r])[0]] * M2)[:M2]
                       for nn, r in zip(nbrs_l, chunk_p)]
            nbr_valid = np.zeros((batch, M2), bool)
            for j, nn in enumerate(nbrs_l):
                nbr_valid[j, :len(nn)] = True
            with profiling.span("mvs.fuse"):
                min_cons = torch.as_tensor([min(geo_min_consistent, len(nn)) for nn in nbrs_l],
                                           dtype=torch.int32, device=dev)
                idx = torch.as_tensor(chunk_p, device=dev)
                nidx = torch.as_tensor(nbr_idx, device=dev)
                pts_b, cols_b, ok_b, vmap_b, fused_b = _fuse_batch(
                    depth_stack[idx], conf_stack[idx], valid_stack[idx], state.poses[idx],
                    depth_stack[nidx], state.poses[nidx], torch.as_tensor(nbr_valid, device=dev),
                    min_cons, K, torch.stack([colors_dev[r] for r in chunk_p]), geo_rel_tol,
                    stride=stride, geometric_check=geometric_check, dist=dist,
                    fuse_depths=fuse_depths, edge_trim_rel=float(edge_trim_rel),
                    free_space_rel=float(free_space_rel),
                    edge_trim_radius=int(edge_trim_radius),
                    edge_keep_conf=float(edge_keep_conf), min_conf=float(min_conf), gray=gray)
            with profiling.span("mvs.copy"):
                for j, r in enumerate(chunk):
                    all_pts.append(pts_b[j][ok_b[j]].cpu().numpy())
                    all_cols.append(cols_b[j][ok_b[j]].cpu().numpy())
            for j, r in enumerate(chunk):
                filtered[r] = DepthMap(depth=fused_b[j], confidence=depth_maps[r].confidence,
                                       valid=vmap_b[j])
        if not all_pts:
            pts = np.zeros((0, 3), np.float32)
            cols = np.zeros((0, 3), np.float32)
        else:
            pts, cols = np.concatenate(all_pts), np.concatenate(all_cols)
        if return_depth_maps:
            return pts, cols, filtered
        return pts, cols
