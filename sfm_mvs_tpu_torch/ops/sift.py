"""SIFT-style feature detection and description.

PyTorch port of ``sfm_mvs_tpu/ops/sift.py:detect_and_compute``. Per
octave: Gaussian scale space and DoG (ops/pyramid.py), strict 26-neighbour
extrema, a closed-form (adjugate) subpixel solve with contrast and edge
rejection, and a per-octave top-K. On the default
``grad_sampling="nearest_polar"`` path a two-stage global top-K follows:
winners by response, their orientations (secondary peaks re-enter as
duplicates), a second top-K, and the 4x4x8 descriptors sampled once for
the final K from the bf16-quantized polar gradient maps. With
``"bilinear"`` every octave candidate samples interpolated (dx, dy) maps
for its orientations and two descriptors, and one global top-K follows.

Selection uses the exact ``torch.topk`` where the JAX package may use
``lax.approx_max_k`` (``approx_topk``); JAX computes the exact top-k on CPU
too, so the two agree there.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sfm_mvs_tpu_torch.ops import pyramid
from sfm_mvs_tpu_torch.utils.config import FrontendConfig

_TWO_PI = 2.0 * math.pi


class Features(NamedTuple):
    """Fixed-capacity keypoints + descriptors for one image."""

    xy: torch.Tensor  # (K, 2) pixel coords in the input image frame
    scale: torch.Tensor  # (K,) blob sigma in input-image pixels
    angle: torch.Tensor  # (K,) dominant orientation, radians
    response: torch.Tensor  # (K,) |DoG contrast|
    desc: torch.Tensor  # (K, 128) L2-normalized descriptors
    valid: torch.Tensor  # (K,) bool


def _pad_edge(x: torch.Tensor) -> torch.Tensor:
    """(L, H, W) -> (L, H+2, W+2), edge replicated spatially."""
    return F.pad(x[None], (1, 1, 1, 1), mode="replicate")[0]


def _neighbor_extrema_mask(dog: torch.Tensor):
    """Strict 26-neighbour max/min masks for DoG layers 1..L-2."""
    L, H, W = dog.shape
    center = dog[1:-1]
    is_max = torch.ones_like(center, dtype=torch.bool)
    is_min = torch.ones_like(center, dtype=torch.bool)
    padded = _pad_edge(dog)
    for dz in (-1, 0, 1):
        sl = padded[1 + dz:1 + dz + L - 2]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz == 0 and dy == 0 and dx == 0:
                    continue
                nb = sl[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                is_max = is_max & (center > nb)
                is_min = is_min & (center < nb)
    return is_max, is_min


def _finite_diffs(dog: torch.Tensor):
    """Central first/second derivatives of the DoG volume at middle layers."""
    p = _pad_edge(dog)
    L, H, W = dog.shape
    c = dog[1:-1]

    def sh(dz, dy, dx):
        return p[1 + dz:1 + dz + L - 2, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    gx = 0.5 * (sh(0, 0, 1) - sh(0, 0, -1))
    gy = 0.5 * (sh(0, 1, 0) - sh(0, -1, 0))
    gs = 0.5 * (sh(1, 0, 0) - sh(-1, 0, 0))
    hxx = sh(0, 0, 1) + sh(0, 0, -1) - 2 * c
    hyy = sh(0, 1, 0) + sh(0, -1, 0) - 2 * c
    hss = sh(1, 0, 0) + sh(-1, 0, 0) - 2 * c
    hxy = 0.25 * (sh(0, 1, 1) - sh(0, 1, -1) - sh(0, -1, 1) + sh(0, -1, -1))
    hxs = 0.25 * (sh(1, 0, 1) - sh(1, 0, -1) - sh(-1, 0, 1) + sh(-1, 0, -1))
    hys = 0.25 * (sh(1, 1, 0) - sh(1, -1, 0) - sh(-1, 1, 0) + sh(-1, -1, 0))
    return (gx, gy, gs), (hxx, hyy, hss, hxy, hxs, hys)


def _solve3_adjugate(hxx, hyy, hss, hxy, hxs, hys, gx, gy, gs):
    """Solve H d = -g for the symmetric 3x3 Hessian, densely per pixel."""
    c00 = hyy * hss - hys * hys
    c01 = hxs * hys - hxy * hss
    c02 = hxy * hys - hxs * hyy
    c11 = hxx * hss - hxs * hxs
    c12 = hxy * hxs - hxx * hys
    c22 = hxx * hyy - hxy * hxy
    det = hxx * c00 + hxy * c01 + hxs * c02
    inv_det = torch.where(det.abs() < 1e-12, torch.zeros_like(det), 1.0 / det)
    dx = -(c00 * gx + c01 * gy + c02 * gs) * inv_det
    dy = -(c01 * gx + c11 * gy + c12 * gs) * inv_det
    ds = -(c02 * gx + c12 * gy + c22 * gs) * inv_det
    return dx, dy, ds


def _octave_candidates(dog: torch.Tensor, cfg: FrontendConfig):
    """Dense candidate maps for one octave: (response (S, H, W), 0 where
    invalid; offsets (dx, dy, ds) each (S, H, W))."""
    S = cfg.scales_per_octave
    H, W = dog.shape[1], dog.shape[2]
    center = dog[1:-1]
    is_max, is_min = _neighbor_extrema_mask(dog)
    prefilter = center.abs() > 0.5 * cfg.contrast_threshold / S
    (gx, gy, gs), hess = _finite_diffs(dog)
    hxx, hyy, hss, hxy, hxs, hys = hess
    dx, dy, ds = _solve3_adjugate(hxx, hyy, hss, hxy, hxs, hys, gx, gy, gs)
    off_ok = (dx.abs() < 1.5) & (dy.abs() < 1.5) & (ds.abs() < 1.5)
    contrast = center + 0.5 * (gx * dx + gy * dy + gs * ds)
    contrast_ok = contrast.abs() > cfg.contrast_threshold / S
    tr = hxx + hyy
    det2 = hxx * hyy - hxy * hxy
    r = cfg.edge_threshold
    edge_ok = (det2 > 0) & (tr * tr * r < (r + 1.0) * (r + 1.0) * det2)
    ys = torch.arange(H, device=dog.device)[None, :, None]
    xs = torch.arange(W, device=dog.device)[None, None, :]
    border_ok = (xs > 0) & (xs < W - 1) & (ys > 0) & (ys < H - 1)
    valid = (is_max | is_min) & prefilter & off_ok & contrast_ok & edge_ok & border_ok
    response = torch.where(valid, contrast.abs(), torch.zeros_like(contrast))
    return response, (dx, dy, ds)


# ---------------------------------------------------------------------------
# Orientation + descriptor
# ---------------------------------------------------------------------------

_ORI_GRID = 16  # orientation window sample grid (16x16)
_ORI_BINS = 36
_DESC_GRID = 16  # descriptor sample grid (16x16 samples over 4x4 bins)


def _bilinear_gather(maps: torch.Tensor, layer: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """Sample maps (C, L, H, W) at (layer, y, x), bilinearly in (y, x).

    layer: (...) integer; x, y: (...) float, clamped into the map. Returns
    (C, ...) samples: four per-corner element gathers. A NaN coordinate
    (only candidates that are invalid anyway carry one) reads a clamped
    index, as XLA's gather clamps.
    """
    C, L, H, W = maps.shape
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    flat = maps.reshape(C, L * H * W)

    def at(yy, xx):
        idx = torch.clamp((layer * H + yy) * W + xx, 0, L * H * W - 1)
        return flat[:, idx.reshape(-1)].reshape((C,) + yy.shape)

    return (at(y0, x0) * (1 - fy) * (1 - fx) + at(y0, x0 + 1) * (1 - fy) * fx
            + at(y0 + 1, x0) * fy * (1 - fx) + at(y0 + 1, x0 + 1) * fy * fx)


def _bilinear_sampler(grads: torch.Tensor, layer: torch.Tensor):
    """sample(sx, sy) -> (mag, ang) of the (dx, dy) maps (2, L, H, W)
    interpolated bilinearly at layer[k] for every window position of
    keypoint k (the JAX package's ``grad_sampling="bilinear"``)."""

    def sample(sx, sy):
        dx, dy = _bilinear_gather(grads, layer[:, None].expand_as(sx), sx, sy)
        return torch.sqrt(dx * dx + dy * dy), torch.remainder(torch.atan2(dy, dx), _TWO_PI)

    return sample


def _polar_planes(grads_dx: torch.Tensor, grads_dy: torch.Tensor):
    """Gradient maps -> (magnitude, angle in [0, 2pi)), each rounded to bf16.

    The JAX package packs the two bf16 values into one uint32 word; two
    bf16 planes hold the same values (torch's uint32 shifts are thin).
    """
    mag = torch.sqrt(grads_dx * grads_dx + grads_dy * grads_dy).to(torch.bfloat16)
    ang = torch.remainder(torch.atan2(grads_dy, grads_dx), _TWO_PI).to(torch.bfloat16)
    return mag, ang


def _orientation(sample, x, y, sigma_oct):
    """Dominant and secondary gradient orientations per keypoint.

    sample(sx, sy) -> (mag, ang) over (K, S) window positions; x, y,
    sigma_oct: (K,) in octave coordinates. Returns (ang1, ang2, has2).
    """
    dev = x.device
    g = _ORI_GRID
    lin = (torch.arange(g, dtype=torch.float32, device=dev) - (g - 1) / 2.0) / ((g - 1) / 2.0)
    gy_off, gx_off = torch.meshgrid(lin, lin, indexing="ij")  # in [-1, 1]
    gx_off = gx_off.reshape(-1)[None, :]
    gy_off = gy_off.reshape(-1)[None, :]
    rad = 4.5 * sigma_oct  # window radius = 4.5 * sigma (3 * 1.5 sigma)
    sx = x[:, None] + rad[:, None] * gx_off
    sy = y[:, None] + rad[:, None] * gy_off
    mag, ang = sample(sx, sy)
    r2 = (gx_off * rad[:, None]) ** 2 + (gy_off * rad[:, None]) ** 2
    w = torch.exp(-r2 / (2.0 * (1.5 * sigma_oct[:, None]) ** 2)) * mag
    # 36-bin histogram with linear two-tap binning, one masked reduction
    # per bin (as in the JAX package: no scatters).
    bin_f = ang * (_ORI_BINS / _TWO_PI)
    b0 = torch.remainder(torch.floor(bin_f).to(torch.int32), _ORI_BINS)
    frac = bin_f - torch.floor(bin_f)
    b1 = torch.remainder(b0 + 1, _ORI_BINS)
    zero = torch.zeros_like(w)
    cols = []
    for b in range(_ORI_BINS):
        wb = torch.where(b0 == b, w * (1.0 - frac), zero) + torch.where(b1 == b, w * frac, zero)
        cols.append(wb.sum(1))
    hist = torch.stack(cols, dim=1)  # (K, 36)
    for _ in range(2):  # circular [1,4,6,4,1]/16 smoothing, twice
        hist = (
            6.0 * hist
            + 4.0 * (torch.roll(hist, 1, dims=1) + torch.roll(hist, -1, dims=1))
            + (torch.roll(hist, 2, dims=1) + torch.roll(hist, -2, dims=1))
        ) / 16.0

    def refine_peak(peak):
        hp = torch.gather(hist, 1, peak[:, None])[:, 0]
        hl = torch.gather(hist, 1, torch.remainder(peak - 1, _ORI_BINS)[:, None])[:, 0]
        hr = torch.gather(hist, 1, torch.remainder(peak + 1, _ORI_BINS)[:, None])[:, 0]
        denom = hl - 2.0 * hp + hr
        shift = torch.where(denom.abs() < 1e-12, torch.zeros_like(denom),
                            0.5 * (hl - hr) / denom)
        a = (peak.to(torch.float32) + shift + 0.5) * (_TWO_PI / _ORI_BINS)
        return torch.remainder(a, _TWO_PI), hp

    peak = torch.argmax(hist, dim=1)
    ang1, h_main = refine_peak(peak)
    is_local_max = (hist >= torch.roll(hist, 1, dims=1)) & (hist > torch.roll(hist, -1, dims=1))
    bins = torch.arange(_ORI_BINS, device=dev)[None, :]
    cand = torch.where(is_local_max & (bins != peak[:, None]), hist, torch.full_like(hist, -1.0))
    peak2 = torch.argmax(cand, dim=1)
    ang2, _ = refine_peak(peak2)
    has2 = (cand.max(dim=1).values >= 0.8 * h_main) & (h_main > 0)
    return ang1, ang2, has2


def _spatial_binning(cfg: FrontendConfig):
    """Static (S, 16) bilinear spatial-bin weights of the descriptor grid and
    the grid's (bx, by) sample offsets in bin units (host-side)."""
    d = cfg.descriptor_width
    g = _DESC_GRID
    lin = ((np.arange(g, dtype=np.float32) + 0.5) / g * d - d / 2.0)
    by_np, bx_np = np.meshgrid(lin, lin, indexing="ij")
    cbx = bx_np.reshape(-1) + d / 2.0 - 0.5
    cby = by_np.reshape(-1) + d / 2.0 - 0.5
    spatial = np.zeros((g * g, d * d), dtype=np.float32)
    for s in range(g * g):
        ix0 = int(np.floor(cbx[s]))
        iy0 = int(np.floor(cby[s]))
        fx_ = cbx[s] - ix0
        fy_ = cby[s] - iy0
        for (ix_, wx_) in ((ix0, 1.0 - fx_), (ix0 + 1, fx_)):
            if not (0 <= ix_ < d):
                continue
            for (iy_, wy_) in ((iy0, 1.0 - fy_), (iy0 + 1, fy_)):
                if not (0 <= iy_ < d):
                    continue
                spatial[s, iy_ * d + ix_] += wx_ * wy_
    return spatial, bx_np.reshape(-1), by_np.reshape(-1)


def _descriptor(sample, x, y, sigma_oct, angle, cfg: FrontendConfig):
    """4x4 spatial x 8 orientation gradient-histogram descriptor (K, 128):
    a rotated 16x16 sample grid, trilinear soft-assignment (the spatial part
    a static matrix product), normalize -> clip 0.2 -> renormalize."""
    d = cfg.descriptor_width
    nb = cfg.descriptor_bins
    dev = x.device
    spatial_np, bx_np, by_np = _spatial_binning(cfg)
    bx = torch.as_tensor(bx_np, device=dev)[None, :]
    by = torch.as_tensor(by_np, device=dev)[None, :]
    hist_width = 3.0 * sigma_oct
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    px = (ca * bx - sa * by) * hist_width[:, None] + x[:, None]
    py = (sa * bx + ca * by) * hist_width[:, None] + y[:, None]
    mag, ang_s = sample(px, py)
    theta = torch.remainder(ang_s - angle[:, None], _TWO_PI)
    r2 = bx * bx + by * by
    w = torch.exp(-r2 / (0.5 * d * d)) * mag  # (K, S)

    obin = theta * (nb / _TWO_PI)
    i0o = torch.floor(obin).to(torch.int32)
    fo = obin - i0o
    b1o = torch.remainder(i0o + 1, nb)
    i0o = torch.remainder(i0o, nb)
    zero = torch.zeros_like(w)
    V = torch.stack(
        [torch.where(i0o == o, w * (1.0 - fo), zero) + torch.where(b1o == o, w * fo, zero)
         for o in range(nb)], dim=-1)  # (K, S, nb)
    spatial = torch.as_tensor(spatial_np, device=dev)
    acc = torch.einsum("kso,sp->kpo", V, spatial)
    desc = acc.reshape(w.shape[0], d * d * nb)
    desc = desc / torch.clamp_min(torch.linalg.norm(desc, dim=1, keepdim=True), 1e-6)
    desc = torch.clamp_max(desc, 0.2)
    return desc / torch.clamp_min(torch.linalg.norm(desc, dim=1, keepdim=True), 1e-6)


# ---------------------------------------------------------------------------
# Full detector
# ---------------------------------------------------------------------------


def _octave_budgets(cfg: FrontendConfig) -> list[int]:
    """Per-octave candidate capacity; pixel count drops 4x per octave."""
    return [max(64, cfg.max_features >> (2 * o)) for o in range(cfg.num_octaves)]


def detect_and_compute(image: torch.Tensor, cfg: FrontendConfig) -> Features:
    """Full SIFT: scale space -> keypoints -> orientation -> descriptors.

    image: (H, W) float32 grayscale in [0, 1] on any device. Returns
    fixed-capacity Features (cfg.max_features slots) in input-image pixels.

    With ``grad_sampling="nearest_polar"`` orientation and descriptors are
    deferred to the global top-K winners and read the bf16 polar maps; with
    ``"bilinear"`` every octave candidate gets its orientations and both
    descriptors from bilinearly interpolated (dx, dy) maps, and one global
    top-K over all octaves' primary and secondary entries picks the result.
    """
    if cfg.grad_sampling not in ("nearest_polar", "bilinear"):
        raise ValueError(f"unknown grad_sampling {cfg.grad_sampling!r}")
    deferred = cfg.grad_sampling == "nearest_polar"
    dev = image.device
    S = cfg.scales_per_octave
    base = pyramid.upsample2(image) if cfg.upsample_input else image
    first_scale = 0.5 if cfg.upsample_input else 1.0  # input px per base px
    assumed = 1.0 if cfg.upsample_input else 0.5  # doubled image doubles blur

    budgets = _octave_budgets(cfg)
    metas = []  # per-octave candidate attributes
    mag_parts, ang_parts = [], []  # flattened per-octave polar maps
    geoms = []  # (h, w) per octave
    per_octave = []  # bilinear path: (primary, secondary) Features per octave
    cur = base
    for o in range(cfg.num_octaves):
        blur_in = assumed if o == 0 else cfg.sigma0
        gauss = pyramid.gaussian_scale_space(
            cur, sigma0=cfg.sigma0, scales_per_octave=S, assumed_blur=blur_in)
        dog = gauss[1:] - gauss[:-1]
        response, (dx, dy, ds) = _octave_candidates(dog, cfg)
        h, w = cur.shape

        pad = _pad_edge(gauss[1:S + 1])
        gdx = 0.5 * (pad[:, 1:-1, 2:] - pad[:, 1:-1, :-2])
        gdy = 0.5 * (pad[:, 2:, 1:-1] - pad[:, :-2, 1:-1])
        if deferred:
            mag, ang = _polar_planes(gdx, gdy)
            mag_parts.append(mag.reshape(-1))
            ang_parts.append(ang.reshape(-1))
            geoms.append((h, w))

        top_resp, top_idx = torch.topk(response.reshape(-1), budgets[o])
        lay = top_idx // (h * w)
        rem = top_idx % (h * w)
        iy = rem // w
        ix = rem % w
        fx = ix.to(torch.float32) + dx.reshape(-1)[top_idx]
        fy = iy.to(torch.float32) + dy.reshape(-1)[top_idx]
        fs = lay.to(torch.float32) + ds.reshape(-1)[top_idx]
        sigma_oct = cfg.sigma0 * torch.exp2((fs + 1.0) / S)
        desc_rad = 3.0 * sigma_oct * (cfg.descriptor_width / 2.0) * math.sqrt(2.0)
        inside = (fx > desc_rad) & (fx < w - 1 - desc_rad) & (fy > desc_rad) & (fy < h - 1 - desc_rad)
        valid = (top_resp > 0.0) & inside
        zero = torch.zeros_like(top_resp)
        if deferred:
            metas.append(dict(
                oct=torch.full(lay.shape, o, dtype=torch.int64, device=dev), lay=lay,
                fx=fx, fy=fy, sigma=sigma_oct, valid=valid,
                response=torch.where(valid, top_resp, zero),
            ))
        else:
            sample = _bilinear_sampler(torch.stack([gdx, gdy]), lay)
            ang1, ang2, has2 = _orientation(sample, fx, fy, sigma_oct)
            valid2 = valid & has2  # secondary-orientation duplicates
            stoi = first_scale * (2.0 ** o)
            xy = torch.stack([fx, fy], dim=-1) * stoi
            sc = sigma_oct * stoi
            per_octave.append(Features(
                xy=xy, scale=sc, angle=ang1, response=torch.where(valid, top_resp, zero),
                desc=_descriptor(sample, fx, fy, sigma_oct, ang1, cfg), valid=valid))
            # Down-weighted infinitesimally, so primaries win top-K ties.
            per_octave.append(Features(
                xy=xy, scale=sc, angle=ang2,
                response=torch.where(valid2, top_resp * 0.999999, zero),
                desc=_descriptor(sample, fx, fy, sigma_oct, ang2, cfg), valid=valid2))
        cur = pyramid.subsample2(gauss[S])

    Kf = cfg.max_features
    if not deferred:
        # One global top-K over every octave's primary and secondary entries.
        allf = Features(*[torch.cat(col, dim=0) for col in zip(*per_octave)])
        top_resp, order = torch.topk(allf.response, Kf)
        return Features(xy=allf.xy[order], scale=allf.scale[order], angle=allf.angle[order],
                        response=top_resp, desc=allf.desc[order],
                        valid=allf.valid[order] & (top_resp > 0.0))

    def cat(k):
        return torch.cat([m[k] for m in metas], dim=0)

    # Stage 1: top-K unique candidates by response.
    top_resp, order = torch.topk(cat("response"), Kf)
    oct_s = cat("oct")[order]
    lay_s = cat("lay")[order]
    fx_s = cat("fx")[order]
    fy_s = cat("fy")[order]
    sig_s = cat("sigma")[order]
    val_s = cat("valid")[order] & (top_resp > 0.0)

    sizes = [S * hh * ww for hh, ww in geoms]
    bases = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]), device=dev)
    big_mag = torch.cat(mag_parts)
    big_ang = torch.cat(ang_parts)
    hs = torch.as_tensor([g[0] for g in geoms], device=dev)
    ws = torch.as_tensor([g[1] for g in geoms], device=dev)

    def make_sample(oct_idx, lay_idx):
        hk = hs[oct_idx][:, None]
        wk = ws[oct_idx][:, None]
        plane = bases[oct_idx][:, None] + lay_idx[:, None] * hk * wk

        def sample(sx, sy):
            ix = torch.clamp(torch.round(sx).to(torch.int64), min=torch.zeros_like(wk), max=wk - 1)
            iy = torch.clamp(torch.round(sy).to(torch.int64), min=torch.zeros_like(hk), max=hk - 1)
            idx = plane + iy * wk + ix
            return big_mag[idx].to(torch.float32), big_ang[idx].to(torch.float32)

        return sample

    ang1, ang2, has2 = _orientation(make_sample(oct_s, lay_s), fx_s, fy_s, sig_s)

    # Stage 2: merge primary + secondary-orientation entries, re-top-K.
    zero = torch.zeros_like(top_resp)
    resp_all = torch.cat([torch.where(val_s, top_resp, zero),
                          torch.where(val_s & has2, top_resp * 0.999999, zero)])
    ang_all = torch.cat([ang1, ang2])
    val_all = torch.cat([val_s, val_s & has2])
    base_idx = torch.cat([torch.arange(Kf, device=dev)] * 2)
    top_resp2, order2 = torch.topk(resp_all, Kf)
    sel = base_idx[order2]
    oct_f = oct_s[sel]
    fx_f = fx_s[sel]
    fy_f = fy_s[sel]
    sig_f = sig_s[sel]
    ang_f = ang_all[order2]
    val_f = val_all[order2] & (top_resp2 > 0.0)

    desc = _descriptor(make_sample(oct_f, lay_s[sel]), fx_f, fy_f, sig_f, ang_f, cfg)
    stoi = first_scale * torch.exp2(oct_f.to(torch.float32))
    return Features(
        xy=torch.stack([fx_f, fy_f], dim=-1) * stoi[:, None],
        scale=sig_f * stoi,
        angle=ang_f,
        response=top_resp2,
        desc=desc,
        valid=val_f,
    )
