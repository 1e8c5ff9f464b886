"""The plain reference that decides ``correct``.

Straightforward float64 PyTorch and numpy, written from the definitions
and not from the port, which it never imports. It judges what a run's
timed path produced; the port's outputs are read only to be judged. The
benchmark builds the inputs (frames, intrinsics, ground truth) and hands
the same to both sides.

Each ``*_gap`` or ``*_mismatch`` function returns one number compared
against a limit in ``limits/<cell>.json``. A ``precision`` argument (or
``dtype``) computes the reference's own answer in the precision below the
float32 (TF32 off) that the configurations state: TF32 where float32
products are matrix products (K1's distances), bfloat16 where they are
elementwise, which TF32 does not reach (triangulation, the plane sweep,
the consistency filter, the cloud's back-projection). Put in the
program's place, that is the control, which has to come out as not
correct (``tests/test_control.py``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

INF = float("inf")


@contextlib.contextmanager
def matmul_precision(precision: str):
    """float32 products in "fp32" (TF32 off) or "tf32"."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


# ---------------------------------------------------------------------------
# 2-NN matching with the ratio test (kernel K1)
# ---------------------------------------------------------------------------


def squared_distances(desc0, desc1, valid1, precision: str = "fp64"):
    """(N0, N1) squared L2 distances, invalid train columns at +inf. The
    descriptors of invalid slots (which may hold NaN) count as zero."""
    desc0 = torch.where(torch.isfinite(desc0), desc0, torch.zeros_like(desc0))
    desc1 = torch.where(valid1[:, None], desc1, torch.zeros_like(desc1))
    if precision == "fp64":
        a, b = desc0.double(), desc1.double()
        cross = a @ b.T
    else:
        a, b = desc0.float(), desc1.float()
        with matmul_precision(precision):
            cross = a @ b.T
    d2 = torch.clamp_min((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * cross, 0.0)
    return torch.where(valid1[None, :], d2, torch.full_like(d2, INF))


def knn2(desc0, desc1, valid0, valid1, ratio: float, precision: str = "fp64"):
    """(idx1, valid) of the nearest train row per query and Lowe's test
    d1 < ratio^2 d2 on squared distances."""
    d2 = squared_distances(desc0, desc1, valid1, precision)
    best = torch.topk(d2, 2, dim=1, largest=False)
    d1, d2nd = best.values[:, 0], best.values[:, 1]
    ok = valid0 & (d1 < (ratio * ratio) * d2nd) & torch.isfinite(d1)
    return best.indices[:, 0], ok


def k1_gap(desc0, desc1, valid0, valid1, ratio: float, idx1, valid) -> float:
    """How far the matcher's answer lies from the float64 reference's.

    Per query, as a share of |q|^2 + |t|^2 (the terms the distance
    expansion cancels): where either side keeps the match, the squared
    distance of the chosen train row above the nearest one; where the two
    disagree on the ratio test, the distance of d1 from ratio^2 d2. A
    match to an invalid row, or kept for an invalid query, is +inf. Sound
    float32 arithmetic reads ~1e-7 (rounding near ties); a wrong row, or
    distances in TF32, read far more.
    """
    d2 = squared_distances(desc0, desc1, valid1)
    best = torch.topk(d2, 2, dim=1, largest=False)
    d1, d2nd = best.values[:, 0], best.values[:, 1]
    ref_ok = valid0 & (d1 < (ratio * ratio) * d2nd) & torch.isfinite(d1)
    j = idx1.long().clamp(0, d2.shape[1] - 1)
    chosen = d2.gather(1, j[:, None])[:, 0]
    chosen = torch.where((idx1 >= 0) & (idx1 < d2.shape[1]), chosen, torch.full_like(chosen, INF))
    sq1 = (desc1.double() ** 2).sum(1)[valid1]
    scale = (torch.nan_to_num(desc0.double()) ** 2).sum(1) + (sq1.median() if sq1.numel() else 1.0)
    either = valid | ref_ok
    gap_idx = torch.where(either, (chosen - d1) / scale, torch.zeros_like(d1))
    flip = (valid != ref_ok) & valid0
    gap_ratio = torch.where(flip, (d1 - (ratio * ratio) * d2nd).abs() / scale,
                            torch.zeros_like(d1))
    bad = valid & ~valid0
    gap = torch.maximum(gap_idx, gap_ratio)
    gap = torch.where(bad, torch.full_like(gap, INF), gap)
    return float(torch.nan_to_num(gap, nan=INF).max()) if gap.numel() else 0.0


# ---------------------------------------------------------------------------
# Poses, points, bundle-adjustment cost
# ---------------------------------------------------------------------------


def camera_centers(poses: np.ndarray) -> np.ndarray:
    """C = -R^T t of (N, 3, 4) world->camera poses."""
    return -np.einsum("nij,ni->nj", poses[:, :, :3], poses[:, :, 3])


def umeyama(src: np.ndarray, dst: np.ndarray):
    """Similarity (s, R, t) minimizing |s R src + t - dst|^2 over rows."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / ((xs ** 2).sum() / len(src))
    return s, R, mu_d - s * R @ mu_s


def ate(poses: np.ndarray, gt: np.ndarray):
    """(RMS of the aligned camera centres' error, the similarity)."""
    est_c, gt_c = camera_centers(poses.astype(np.float64)), camera_centers(gt)
    s, R, t = umeyama(est_c, gt_c)
    err = est_c @ (s * R).T + t - gt_c
    return float(np.sqrt((err ** 2).sum(1).mean())), (s, R, t)


def reprojection_cost(poses, points, obs_uv, obs_mask, point_valid, cam_valid, K) -> float:
    """Mean squared pixel residual over the observed (point, camera) cells
    of a map, in float64: the objective bundle adjustment reports."""
    P_, X = poses.double(), points.double()
    Kt = torch.as_tensor(K, dtype=torch.float64, device=X.device)
    Xc = torch.einsum("cij,pj->pci", P_[:, :, :3], X) + P_[:, :, 3][None]
    z = Xc[..., 2]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = Kt[0, 0] * Xc[..., 0] / z + Kt[0, 1] * Xc[..., 1] / z + Kt[0, 2]
    v = Kt[1, 1] * Xc[..., 1] / z + Kt[1, 2]
    r2 = (u - obs_uv[..., 0].to(u.dtype)) ** 2 + (v - obs_uv[..., 1].to(u.dtype)) ** 2
    w = obs_mask & point_valid[:, None] & cam_valid[None, :]
    total = torch.where(w, r2, torch.zeros_like(r2)).sum()
    return float(total / torch.clamp_min(w.sum(), 1).to(total.dtype))


def triangulate(P1, P2, uv1, uv2, dtype=torch.float64):
    """Two-view DLT points (..., N, 3) of cameras (..., 3, 4) and pixels
    (..., N, 2): the rows u P[2] - P[0], v P[2] - P[1] of both views, each
    scaled to unit norm, solved in least squares for X = (x, y, z, 1). The
    rows are built in `dtype` (bfloat16 in the control), the 3x3 solve in
    float64 (float32 below it)."""
    rows = []
    for P_, uv in ((P1, uv1), (P2, uv2)):
        P_, uv = P_.to(dtype)[..., None, :, :], uv.to(dtype)
        rows += [uv[..., 0, None] * P_[..., 2, :] - P_[..., 0, :],
                 uv[..., 1, None] * P_[..., 2, :] - P_[..., 1, :]]
    A = torch.stack(torch.broadcast_tensors(*rows), -2)  # (..., N, 4, 4)
    A = A / torch.linalg.norm(A.float(), dim=-1, keepdim=True).clamp_min(1e-12).to(dtype)
    solve = torch.float64 if dtype == torch.float64 else torch.float32
    A = A.to(solve)
    return torch.linalg.lstsq(A[..., :3], -A[..., 3:]).solution[..., 0]


def tri_gap(points, P1, P2, uv1, uv2, center2) -> float:
    """Largest distance of triangulated points from the float64 DLT points
    of the same observations, as a share of their distance from the second
    camera (0 with no points)."""
    if points.shape[0] == 0:
        return 0.0
    ref = triangulate(P1.double(), P2.double(), uv1.double(), uv2.double())
    err = (points.double() - ref).norm(dim=1) / (ref - center2).norm(dim=1).clamp_min(1e-9)
    return float(torch.nan_to_num(err, nan=INF).max())


def relative_gap(value: float, ref: float) -> float:
    return abs(value - ref) / max(abs(ref), 1e-30)


# ---------------------------------------------------------------------------
# Depth maps and the fused cloud (MVS)
# ---------------------------------------------------------------------------


def depth_errors(depth_maps, gt_depths, scale: float):
    """(rel-RMS, median relative error, share of ground-truth pixels left
    uncovered) of filtered depth maps [(frame, depth, valid)] against the
    rendered depths (> 0.1), after scaling by the reconstruction's
    similarity scale."""
    rels, uncovered = [], []
    for r, d, valid in depth_maps:
        d_gt = gt_depths[r]
        gt_ok = d_gt > 0.1
        ok = valid & gt_ok
        uncovered.append(1.0 - ok.sum() / max(gt_ok.sum(), 1))
        rels.append(np.abs(d[ok] * scale - d_gt[ok]) / d_gt[ok])
    rel = np.concatenate(rels)
    if rel.size == 0:
        return INF, INF, 1.0
    return float(np.sqrt(np.mean(rel ** 2))), float(np.median(rel)), float(np.mean(uncovered))


def grid_points(depth, pose, K, stride: int, precision: str = "fp64"):
    """World points of every `stride`-th pixel of a depth map (H, W), in
    row-major order: R^T (d K^-1 [u, v, 1] - t), in float64, or in "bf16"
    (the control)."""
    H, W = depth.shape
    dt = torch.float64 if precision == "fp64" else torch.bfloat16
    dev = depth.device
    ys, xs = torch.meshgrid(torch.arange(0, H, stride, dtype=dt, device=dev),
                            torch.arange(0, W, stride, dtype=dt, device=dev), indexing="ij")
    Kinv = torch.linalg.inv(torch.as_tensor(K, dtype=torch.float64, device=dev)).to(dt)
    d = depth[::stride, ::stride].to(dt)
    R, t = pose[:, :3].to(dt), pose[:, 3].to(dt)
    rays = torch.stack([xs, ys, torch.ones_like(xs)], -1) @ Kinv.T
    return (((rays * d[..., None]) - t) @ R).reshape(-1, 3)


def backproject(depth, valid, pose, K, stride: int, precision: str = "fp64"):
    """The world points of the valid pixels among every `stride`-th."""
    return grid_points(depth, pose, K, stride, precision)[valid[::stride, ::stride].reshape(-1)]


def cloud(depth_maps, poses, K, stride: int, precision: str = "fp64"):
    """The back-projections of depth maps [(frame, depth, valid)], in order."""
    parts = [backproject(d, v, poses[r], K, stride, precision) for r, d, v in depth_maps]
    return torch.cat(parts) if parts else torch.zeros((0, 3), dtype=torch.float64)


def cloud_gap(points: np.ndarray, depth_maps, poses, K, stride: int) -> float:
    """Largest distance of a cloud point from the reference's
    back-projection of the fused depth maps, as a share of its depth
    (+inf where the counts differ)."""
    ref = cloud(depth_maps, poses, K, stride)
    if ref.shape[0] != points.shape[0]:
        return INF
    if ref.shape[0] == 0:
        return 0.0
    prog = torch.as_tensor(points, device=ref.device).double()
    depth = torch.cat([d[::stride, ::stride].reshape(-1)[v[::stride, ::stride].reshape(-1)]
                       for _, d, v in depth_maps]).double()
    err = (prog - ref).norm(dim=1) / depth.clamp_min(1e-6)
    return float(torch.nan_to_num(err, nan=INF).max())


# ---------------------------------------------------------------------------
# MVS pass 1: the coarse-to-fine plane sweep of one reference view
# ---------------------------------------------------------------------------
#
# The sweep's definition, as the configured deployment runs it: per
# reference view, pyramids of 2x2 means, each level zero-meaned by a
# (2r+1)^2 box mean (edge-replicated); at the coarsest level every one of
# the `num_depths` uniform inverse depths between 1/hi and 1/lo, neighbor
# images sampled at the nearest pixel; at each finer level the upsampled
# inverse depth +- half-size steps, plus the 3x3 min and max of the coarser
# inverse depth (escape hypotheses), sampled bilinearly. A hypothesis's cost
# per pixel is the box mean of the neighbors' summed |warped - reference|
# over the box mean of the neighbors that see it. Depth is the argmin (the
# first on ties) with a parabolic sub-step over the uniform hypotheses;
# confidence is the coarse sweep's (mean - best) / mean, upsampled.


def _box(x, r: int):
    """Mean over the (2r+1)^2 window of the last two axes, edges replicated."""
    lead, hw = x.shape[:-2], x.shape[-2:]
    y = F.pad(x.reshape((-1, 1) + hw), (r, r, r, r), mode="replicate")
    return F.avg_pool2d(y, 2 * r + 1, stride=1).reshape(lead + hw)


def _half(x):
    """2x2 means (an odd trailing row or column dropped)."""
    lead = x.shape[:-2]
    y = F.avg_pool2d(x.reshape((-1, 1) + x.shape[-2:]), 2)
    return y.reshape(lead + y.shape[-2:])


def _pool3(x, largest: bool):
    """3x3 max (or min) over the last two axes, the border left out."""
    lead = x.shape[:-2]
    y = x.reshape((-1, 1) + x.shape[-2:])
    y = F.max_pool2d(y, 3, 1, 1) if largest else -F.max_pool2d(-y, 3, 1, 1)
    return y.reshape(lead + y.shape[-2:])


def _upsample(x, size):
    """Bilinear with half-pixel centres, border taps clamped."""
    return F.interpolate(x[None, None], size=tuple(size), mode="bilinear",
                         align_corners=False)[0, 0]


def _level_K(K, s: float):
    """Intrinsics of an image shrunk s times (pixel centres at integers)."""
    S = torch.tensor([[1 / s, 0, 0.5 / s - 0.5], [0, 1 / s, 0.5 / s - 0.5], [0, 0, 1]],
                     dtype=K.dtype, device=K.device)
    return S @ K


def _rays(H: int, W: int, K):
    """(H*W, 3) rays K^-1 [x, y, 1] of the pixel grid in row-major order."""
    ys, xs = torch.meshgrid(torch.arange(H, dtype=K.dtype, device=K.device),
                            torch.arange(W, dtype=K.dtype, device=K.device), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    return pix @ torch.linalg.inv(K.double()).to(K.dtype).T


def _sample(img, x, y, nearest: bool):
    """img (M, H, W) at (M, P) coordinates: (values, inside). Nearest rounds
    half to even; bilinear clamps to [0, size - 1.001] (H, W >= 2)."""
    H, W = img.shape[-2:]
    inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    flat = img.reshape(img.shape[0], -1)
    # Indices are clamped as integers, after the cast: a coordinate that is
    # NaN (as bfloat16 arithmetic can make one) casts to any integer.
    if nearest:
        ix = torch.round(x).long().clamp(0, W - 1)
        iy = torch.round(y).long().clamp(0, H - 1)
        return flat.gather(1, iy * W + ix), inside
    x = x.clamp(0.0, W - 1.001)
    y = y.clamp(0.0, H - 1.001)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    i = y0.long().clamp(0, H - 2) * W + x0.long().clamp(0, W - 2)
    g = lambda k: flat.gather(1, k)  # noqa: E731
    v = (g(i) * (1 - fy) * (1 - fx) + g(i + 1) * (1 - fy) * fx
         + g(i + W) * fy * (1 - fx) + g(i + W + 1) * fy * fx)
    return v, inside


def _select(ref, nbrs, KL, R_rel, t_rel, hyps, n_uniform: int, step, radius: int,
            nearest: bool):
    """Costs of the (H, W) inverse-depth maps `hyps` (the first `n_uniform`
    uniform steps of `step` apart), the argmin with the parabolic sub-step,
    and (inverse depth, best cost, mean uniform cost, seeing neighbors at
    the best)."""
    H, W = ref.shape
    a = torch.einsum("mij,pj->mpi", R_rel, _rays(H, W, KL))  # (M, HW, 3)
    fx, fy, cx, cy = KL[0, 0], KL[1, 1], KL[0, 2], KL[1, 2]
    costs, dens = [], []
    for iv in hyps:
        q = a + t_rel[:, None, :] * iv.reshape(1, -1, 1)
        z = q[..., 2]
        zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        vals, inside = _sample(nbrs, fx * q[..., 0] / zs + cx, fy * q[..., 1] / zs + cy, nearest)
        w = (inside & (z > 1e-6)).to(ref.dtype)
        num = ((vals - ref.reshape(1, -1)).abs() * w).sum(0).reshape(H, W)
        den = w.sum(0).reshape(H, W)
        nf, df = _box(num, radius), _box(den, radius)
        costs.append(torch.where(df > 1e-6, nf / df.clamp_min(1e-6), torch.ones_like(nf)))
        dens.append(den)
    costs, dens = torch.stack(costs), torch.stack(dens)
    cu = costs[:n_uniform]
    bu = cu.argmin(0)
    c1 = cu.min(0).values
    c0 = cu.gather(0, (bu - 1).clamp(0, n_uniform - 1)[None])[0]
    c2 = cu.gather(0, (bu + 1).clamp(0, n_uniform - 1)[None])[0]
    den2 = c0 - 2 * c1 + c2
    shift = torch.where(den2.abs() < 1e-9, torch.zeros_like(den2), 0.5 * (c0 - c2) / den2)
    stack = torch.stack(hyps)
    inv_u = stack[:n_uniform].gather(0, bu[None])[0] + shift.clamp(-1.0, 1.0) * step
    best = costs.argmin(0)
    invd = torch.where(best < n_uniform, inv_u, stack.gather(0, best[None])[0])
    return (invd, costs.min(0).values, cu.mean(0), dens.gather(0, best[None])[0])


def plane_sweep(ref, nbrs, pose, nposes, K, lo: float, hi: float, sweep: dict,
                dtype=torch.float64):
    """One reference view's (depth, confidence, valid) maps, computed in
    `dtype`. ref (H, W), nbrs (M, H, W) gray, pose (3, 4) and nposes
    (M, 3, 4) world->camera, [lo, hi] the view's depth range; `sweep` holds
    num_depths, cost_radius, coarse_levels, refine_hyps, refine_hyps_final,
    escape_final and min_confidence."""
    ref, nbrs = ref.to(dtype), nbrs.to(dtype)
    pose, nposes = pose.to(torch.float64), nposes.to(torch.float64)
    K = torch.as_tensor(K, dtype=torch.float64, device=ref.device)
    R_rel = nposes[:, :, :3] @ pose[:, :3].T
    t_rel = nposes[:, :, 3] - R_rel @ pose[:, 3]
    R_rel, t_rel = R_rel.to(dtype), t_rel.to(dtype)
    r, L, D = sweep["cost_radius"], sweep["coarse_levels"], sweep["num_depths"]
    refs, nbs = [ref], [nbrs]
    for _ in range(L):
        refs.append(_half(refs[-1]))
        nbs.append(_half(nbs[-1]))
    refs = [x - _box(x, r) for x in refs]
    nbs = [x - _box(x, r) for x in nbs]
    inv_lo, inv_hi = 1.0 / hi, 1.0 / lo
    step = (inv_hi - inv_lo) / max(D - 1, 1)
    zero = torch.zeros_like(refs[L])
    hyps = [zero + (inv_lo + (inv_hi - inv_lo) * d / (D - 1) if D > 1 else inv_lo)
            for d in range(D)]
    invd, best, mean, den = _select(refs[L], nbs[L], _level_K(K, 2.0 ** L).to(dtype), R_rel,
                                    t_rel, hyps, D, step, r, nearest=True)
    conf = ((mean - best) / mean.clamp_min(1e-6)).clamp(0.0, 1.0)
    for lev in range(L - 1, -1, -1):
        size = refs[lev].shape
        escape = [_upsample(_pool3(invd, False), size), _upsample(_pool3(invd, True), size)]
        invd, conf = _upsample(invd, size), _upsample(conf, size)
        step = step * 0.5
        nh = sweep["refine_hyps"]
        if lev == 0 and sweep["refine_hyps_final"] > 0:
            nh = sweep["refine_hyps_final"]
            if not sweep["escape_final"]:
                escape = []
        hyps = [invd + (k - (nh - 1) / 2.0) * step for k in range(nh)] + escape
        invd, _, _, den = _select(refs[lev], nbs[lev], _level_K(K, 2.0 ** lev).to(dtype), R_rel,
                                  t_rel, hyps, nh, step, r, nearest=False)
    invd = invd.clamp(inv_lo * 0.5, inv_hi * 2.0)
    depth = 1.0 / invd.clamp_min(1e-6)
    return depth, conf, (conf > sweep["min_confidence"]) & (den > 0.5)


def depth_ranges(points, point_valid, poses) -> np.ndarray:
    """(C, 2) per-camera depth ranges from a sparse cloud: the 2% and 98%
    quantiles of the positive depths of its valid points, times 0.7 and 1.4
    (1 and 10 where a camera sees no point in front)."""
    X = points.double().cpu().numpy()[point_valid.cpu().numpy()]
    P_ = poses.double().cpu().numpy()
    out = np.tile(np.array([1.0, 10.0]), (P_.shape[0], 1))
    for c in range(P_.shape[0]):
        z = X @ P_[c, 2, :3] + P_[c, 2, 3]
        z = z[z > 0]
        if z.size:
            out[c] = np.quantile(z, [0.02, 0.98])
    return out * np.array([0.7, 1.4])


def sweep_neighbors(r: int, n: int, k: int) -> list:
    """The +-k views around view r, padded to 2k by repeating the first."""
    nn = [i for i in range(max(0, r - k), min(n, r + k + 1)) if i != r]
    return (nn + [nn[0]] * (2 * k))[:2 * k]


def sweep_mismatch(prog, ref, step: float, surface) -> float:
    """Share of the pixels on the rendered surface (``surface``) on which
    two sweeps of one view disagree: valid in one only, or valid in both
    with inverse depths more than `step` (the finest level's hypothesis
    step) apart. prog and ref: (depth, valid). Where no surface was
    rendered the image is flat, every hypothesis costs the same and
    rounding alone picks one, so those pixels are left out."""
    (dp, vp), (dr, vr) = prog, ref
    far = (1.0 / dp.double().clamp_min(1e-9) - 1.0 / dr.double().clamp_min(1e-9)).abs() > step
    bad = ((vp != vr) | (vp & vr & far)) & surface
    return float(bad.sum()) / max(int(surface.sum()), 1)


# ---------------------------------------------------------------------------
# MVS pass 2: the geometric-consistency filter and fusion of one view
# ---------------------------------------------------------------------------


def consistency(depth, conf, valid, pose, nbr_depths, nbr_poses, K, settings: dict,
                min_consistent: int, dtype=torch.float64):
    """One view's filtered, fused (depth, valid) from the pass-1 maps.

    Each pixel, back-projected at its depth, is projected into every
    neighbor (``nbr_depths`` (M, H, W) their pass-1 depths, read at the
    nearest pixel). A neighbor in front whose depth agrees within
    ``geo_rel_tol`` votes for it; one whose surface lies more than
    ``free_space_rel`` behind it vetoes it. The pixel stays where it was
    valid, has ``min_consistent`` votes, no veto and confidence above
    ``min_conf``, and takes the mean of its depth and the voters' implied
    depths. Pixels on the near side of a depth jump (max - min over a
    (2 ``edge_trim_radius`` + 1)^2 window above ``edge_trim_rel`` of the
    depth) drop unless their confidence exceeds ``edge_keep_conf``.
    """
    depth, conf = depth.to(dtype), conf.to(dtype)
    nbr_depths = nbr_depths.to(dtype)
    H, W = depth.shape
    K = torch.as_tensor(K, dtype=torch.float64, device=depth.device)
    X = _rays(H, W, K.to(dtype)) * depth.reshape(-1, 1)
    pose, nbr_poses = pose.to(dtype), nbr_poses.to(dtype)
    Xw = (X - pose[:, 3]) @ pose[:, :3]  # R^T (X - t)
    Xn = torch.einsum("mij,pj->mpi", nbr_poses[:, :, :3], Xw) + nbr_poses[:, None, :, 3]
    z = Xn[..., 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = Xn[..., 0] / zs * K[0, 0].to(dtype) + K[0, 2].to(dtype)
    v = Xn[..., 1] / zs * K[1, 1].to(dtype) + K[1, 2].to(dtype)
    seen, inside = _sample(nbr_depths, u, v, nearest=True)
    front = inside & (z > 0)
    zc = z.clamp_min(1e-6)
    agree = front & ((seen - z).abs() < settings["geo_rel_tol"] * zc)
    veto = front & (seen > z * (1.0 + settings["free_space_rel"]))
    d = depth.reshape(1, -1)
    n_agree = agree.sum(0)
    keep = valid.reshape(-1) & (n_agree >= min_consistent) & ~veto.any(0)
    if settings["min_conf"] > 0:
        keep = keep & (conf.reshape(-1) > settings["min_conf"])
    fused = (d[0] + (d * seen / zc * agree).sum(0)) / (1.0 + n_agree)
    out = torch.where(keep, fused, d[0]).reshape(H, W)
    keep = keep.reshape(H, W)
    rel = settings["edge_trim_rel"]
    if rel > 0:
        dmax, dmin = out, out
        for _ in range(settings["edge_trim_radius"]):
            dmax, dmin = _pool3(dmax, True), _pool3(dmin, False)
        jump = (dmax - dmin) > rel * out.clamp_min(1e-6)
        near = out < dmin * (1.0 + rel)
        keep = keep & ~(jump & near & ~(conf > settings["edge_keep_conf"]))
    return out, keep


def geo_neighbors(r: int, n: int, k: int) -> list:
    """The +-k views around view r that the filter reads (no padding)."""
    return [i for i in range(max(0, r - k), min(n, r + k + 1)) if i != r]


def fuse_mismatch(prog, ref, rel: float) -> float:
    """Share of pixels on which two filtered, fused maps of one view
    disagree: kept by one only, or kept by both with depths more than
    `rel` of the reference's apart. prog and ref: (depth, valid)."""
    (dp, vp), (dr, vr) = prog, ref
    far = (dp.double() - dr.double()).abs() > rel * dr.double().abs()
    return float(((vp != vr) | (vp & vr & far)).double().mean())
