"""The plain reference of the view-graph cell (gustav57-viewgraph).

Float64 PyTorch and numpy, written from the definitions and from the
port's docstrings, never from its code, and importing nothing of the port
(``portbench.reference`` supplies K1's 2-NN and the map's reprojection
cost). It judges what a pass produced:

- a pair's geometry: the inliers of a given essential matrix E by its
  Sampson distance in pixels, the least-squares 8-point E of a weighted
  set of correspondences, E -> (R, t) by SVD with the cheirality vote
  over a given inlier set, and the rotation-compensated parallax;
- the choice rules of the bootstrap pair (with the bootstrap guard's
  retries) and of the loop-closure pairs;
- the gate of an injected loop-closure observation.

A ``dtype`` argument computes the same in bfloat16, the precision below
the configuration's float32 for elementwise work: put in the view graph's
place, that is the control, which has to come out as not correct.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from portbench import reference

F64 = torch.float64


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


# ---------------------------------------------------------------------------
# One pair's geometry
# ---------------------------------------------------------------------------


def normalize(uv, Kinv) -> torch.Tensor:
    """Pixels (N, 2) to normalized camera coordinates, K^-1 [u, v, 1], in
    the dtype of Kinv."""
    return (_homogeneous(uv.to(Kinv.dtype)) @ Kinv.T)[:, :2]


def sampson_px(E, n0, n1, focal: float, dtype=F64) -> torch.Tensor:
    """Sampson distance of each correspondence (normalized camera
    coordinates n0 in view 0, n1 in view 1, x1^T E x0 = 0), in pixels:
    |x1^T E x0| / sqrt((E x0)_1^2 + (E x0)_2^2 + (E^T x1)_1^2 + (E^T x1)_2^2),
    times the focal length."""
    E, x0, x1 = E.to(dtype), _homogeneous(n0.to(dtype)), _homogeneous(n1.to(dtype))
    Ex0 = x0 @ E.T
    Etx1 = x1 @ E
    num = (x1 * Ex0).sum(-1)
    den = Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Etx1[:, 0] ** 2 + Etx1[:, 1] ** 2
    d = num.abs() / torch.sqrt(torch.clamp_min(den, 1e-24))
    return d.to(F64) * focal


def inliers(E, n0, n1, valid, focal: float, threshold_px: float, dtype=F64) -> torch.Tensor:
    """The correspondences of a given E under the threshold, among the valid."""
    return valid & (sampson_px(E, n0, n1, focal, dtype) < threshold_px)


def inlier_gap(count: int, E, n0, n1, valid, focal: float, threshold_px: float) -> float:
    """How far a reported inlier count lies from the float64 recount of the
    same E over the same correspondences, as a share of the recount."""
    ref = int(inliers(E, n0, n1, valid, focal, threshold_px).sum())
    return abs(int(count) - ref) / max(ref, 1)


def eight_point(n0, n1, weights=None, dtype=F64) -> torch.Tensor:
    """The essential matrix whose x1^T E x0 = 0 fits the correspondences
    (normalized camera coordinates (..., N, 2), rows weighted by `weights`
    (..., N)) in the least-squares sense: the right singular vector of the
    design matrix's smallest singular value (rows kron(x1, x0)), projected
    onto the essential matrices (singular values 1, 1, 0). Batched over the
    leading dimensions. The design matrix is formed in `dtype`; the SVDs run
    in float64 (float32 below it). Returns float64."""
    svd_dtype = F64 if dtype == F64 else torch.float32
    x0, x1 = _homogeneous(n0.to(dtype)), _homogeneous(n1.to(dtype))
    A = (x1[..., :, None] * x0[..., None, :]).flatten(-2)  # (..., N, 9)
    if weights is not None:
        A = A * weights.to(dtype)[..., None]
    e = torch.linalg.svd(A.to(svd_dtype))[2][..., -1, :]
    U, _, Vt = torch.linalg.svd(e.reshape(e.shape[:-1] + (3, 3)))
    diag = torch.tensor([1.0, 1.0, 0.0], dtype=svd_dtype, device=e.device)
    return ((U * diag) @ Vt).to(F64)


def solve_gap(E, n0, n1, weights, focal: float) -> float:
    """How far a given 8-point solve E of weighted correspondences lies from
    the float64 :func:`eight_point` of the same: the RMS, over the
    correspondences of positive weight, of the difference of the two E's
    float64 Sampson distances, pixels."""
    w = weights > 0
    ref = eight_point(n0, n1, weights.to(F64))
    d = sampson_px(E, n0, n1, focal)[w] - sampson_px(ref, n0, n1, focal)[w]
    return float(torch.sqrt((d * d).mean())) if d.numel() else 0.0


def decompose(E, n0, n1, mask, dtype=F64):
    """The relative pose (R, unit t) of an essential matrix: of the four
    candidates of E = U diag(1, 1, 0) V^T, R = U W V^T or U W^T V^T with t =
    +-U[:, 2] (U and V taken with determinant +1), the one that puts the
    most of the masked correspondences in front of both cameras (the first
    of equals, in that order). The depths come from the two-view DLT of
    ``reference.triangulate`` in `dtype`; the SVD runs in float64 (float32
    below it)."""
    svd_dtype = F64 if dtype == F64 else torch.float32
    U, _, Vt = torch.linalg.svd(E.to(dtype).to(svd_dtype))
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=svd_dtype,
                     device=E.device)
    R1, R2, t = U @ W @ Vt, U @ W.T @ Vt, U[:, 2]
    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    P0 = torch.cat([torch.eye(3, dtype=svd_dtype, device=E.device),
                    torch.zeros(3, 1, dtype=svd_dtype, device=E.device)], 1)
    n0m, n1m = n0[mask], n1[mask]
    best, best_n = 0, -1
    for k, (R, tk) in enumerate(cands):
        P1 = torch.cat([R, tk[:, None]], 1)
        X = reference.triangulate(P0, P1, n0m, n1m, dtype).to(svd_dtype)
        z0 = X[:, 2]
        z1 = X @ R[2] + tk[2]
        n = int(((z0 > 0) & (z1 > 0)).sum())
        if n > best_n:
            best, best_n = k, n
    R, tk = cands[best]
    return R.to(F64), (tk / torch.linalg.norm(tk)).to(F64)


def rotation_angle_deg(Ra, Rb) -> float:
    """The angle of the rotation Ra Rb^T, degrees."""
    Ra, Rb = torch.as_tensor(Ra, dtype=F64), torch.as_tensor(Rb, dtype=F64).to(Ra.device)
    c = ((torch.trace(Ra @ Rb.T) - 1.0) / 2.0).clamp(-1.0, 1.0)
    return float(torch.rad2deg(torch.arccos(c)))


def direction_angle_deg(ta, tb) -> float:
    """The angle between two translation directions, degrees."""
    ta, tb = torch.as_tensor(ta, dtype=F64), torch.as_tensor(tb, dtype=F64).to(ta.device)
    n = torch.linalg.norm(ta) * torch.linalg.norm(tb)
    if not float(n) > 0.0:
        return 180.0
    return float(torch.rad2deg(torch.arccos(((ta @ tb) / n).clamp(-1.0, 1.0))))


def pose_gap(R, t, R_ref, t_ref) -> float:
    """The larger of the rotation and the translation-direction angles
    between a pose and the reference's, degrees."""
    return max(rotation_angle_deg(R, R_ref), direction_angle_deg(t, t_ref))


def parallax_deg(R, n0, n1, mask, dtype=F64) -> float:
    """Mean angle over the masked correspondences between the ray of view
    0 turned into view 1 (R x0) and the ray of view 1, degrees."""
    R = torch.as_tensor(R).to(dtype)
    r0 = _homogeneous(n0.to(dtype))
    r1 = _homogeneous(n1.to(dtype))
    r0 = r0 / torch.linalg.norm(r0, dim=1, keepdim=True)
    r1 = r1 / torch.linalg.norm(r1, dim=1, keepdim=True)
    c = ((r0 @ R.T) * r1).sum(1).to(F64).clamp(-1.0, 1.0)
    ang = torch.rad2deg(torch.arccos(c))
    m = mask.to(torch.bool)
    return float(ang[m].sum() / max(int(m.sum()), 1))


# ---------------------------------------------------------------------------
# Choice rules
# ---------------------------------------------------------------------------


def _by_inliers(idx, num_inliers) -> list:
    """Pair indices by inlier count, highest first; ties: lower index first."""
    return sorted(idx, key=lambda i: (-int(num_inliers[i]), i))


def bootstrap_candidates(pair_i, pair_j, num_inliers, parallax_deg_, min_inliers: int = 50,
                         min_parallax_deg: float = 1.0) -> list:
    """Pairs fit to initialize from, best first: those with at least
    `min_inliers` inliers and `min_parallax_deg` parallax by inlier count;
    then those passing only at a quarter of the parallax floor; then at no
    parallax floor. Where no pair has the inliers, the strongest pair."""
    M = len(pair_i)
    out, seen = [], set()
    for floor in (min_parallax_deg, 0.25 * min_parallax_deg, 0.0):
        ok = [i for i in range(M) if num_inliers[i] >= min_inliers
              and parallax_deg_[i] >= floor and i not in seen]
        for i in _by_inliers(ok, num_inliers):
            seen.add(i)
            out.append((int(pair_i[i]), int(pair_j[i])))
    if not out and M:
        i = _by_inliers(range(M), num_inliers)[0]
        out.append((int(pair_i[i]), int(pair_j[i])))
    return out


def loop_pairs(pair_i, pair_j, num_inliers, top_k: int, min_gap: int = 3,
               min_inliers: int = 30) -> list:
    """The top-K pairs at least `min_gap` frames apart with at least
    `min_inliers` inliers, by inlier count."""
    ok = [i for i in range(len(pair_i))
          if abs(int(pair_j[i]) - int(pair_i[i])) >= min_gap and num_inliers[i] >= min_inliers]
    return [(int(pair_i[i]), int(pair_j[i])) for i in _by_inliers(ok, num_inliers)[:top_k]]


def guarded_bootstrap(candidates: list, disagreement: Callable[[int, int, int], Optional[tuple]],
                      max_rot_deg: float, max_dir_deg: float, streams: int, pairs: int):
    """The tries of the bootstrap guard and the pair it keeps.

    The tries walk the first `pairs` candidates, `streams` generator streams
    each; a try passes when its rotation lies within `max_rot_deg` and its
    translation direction within `max_dir_deg` of the view graph's pair; the
    first that passes ends the walk; where none does, the pair of the try
    whose larger angle over its limit is least. `disagreement(a, b, k)` gives
    a try's (rotation, direction) angles, or None where the program made no
    such try. Returns (the tries as (a, b, k), the pair kept), or None where
    a try the rule asks for is missing."""
    tried, best = [], None
    for a, b in candidates[:pairs]:
        for k in range(streams):
            d = disagreement(a, b, k)
            if d is None:
                return None
            tried.append((a, b, k))
            excess = max(d[0] / max_rot_deg, d[1] / max_dir_deg)
            if excess <= 1.0:
                return tried, (a, b)
            if best is None or excess < best[0]:
                best = (excess, (a, b))
    return tried, (best[1] if best else None)


# ---------------------------------------------------------------------------
# Loop-closure observations
# ---------------------------------------------------------------------------


def project(points, pose, K, dtype=F64):
    """Pixels (N, 2) and depths (N,) of world points under a world->camera
    pose (3, 4) and intrinsics K."""
    X, P = points.to(dtype), torch.as_tensor(pose).to(points.device, dtype)
    Kt = torch.as_tensor(K).to(points.device, dtype)
    Xc = X @ P[:, :3].T + P[:, 3]
    z = Xc[:, 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    uv = torch.stack([Kt[0, 0] * Xc[:, 0] / zs + Kt[0, 1] * Xc[:, 1] / zs + Kt[0, 2],
                      Kt[1, 1] * Xc[:, 1] / zs + Kt[1, 2]], dim=1)
    return uv.to(F64), z.to(F64)


def inject_rejected(points, point_valid, observed, pose, K, pids, uv, gate_px: float,
                    dtype=F64) -> int:
    """How many of the observations (pids, uv) injected into one camera the
    gate rejects, against the map they were injected into: the point live,
    in front of the camera, reprojected within `gate_px` of uv, and not yet
    observed there (`observed`: that camera's observation mask before)."""
    if pids.numel() == 0:
        return 0
    pid = pids.long()
    proj, z = project(points[pid], pose, K, dtype)
    err = torch.linalg.norm(proj - uv.to(F64), dim=1)
    ok = point_valid[pid] & (z > 0) & (err < gate_px) & ~observed[pid]
    return int((~ok).sum())
