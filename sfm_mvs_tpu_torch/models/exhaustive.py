"""View graph: pairwise match strength and geometry for bootstrap selection.

PyTorch port of the view-graph part of ``sfm_mvs_tpu/models/exhaustive.py``
(``ViewGraph``, ``_pair_geometry``, ``build_view_graph``,
``best_bootstrap_pair``). Every frame pair within the window is matched,
gets an E-RANSAC inlier count, a relative pose and a parallax angle; the
auto-bootstrap driver picks its initial pair from them. The JAX package
matches these pairs with its plain XLA matcher; here the pairs go through
the 2-NN kernel on CUDA tensors (the same function; its wrapper takes the
plain version for CPU tensors), or the plain matcher with
``use_pallas_matcher=False``. The loop-closure and stitching functions of
that module wait for ROADMAP A12.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from sfm_mvs_tpu_torch.models.incremental import resolve_device
from sfm_mvs_tpu_torch.ops import matching, projection, ransac, sift
from sfm_mvs_tpu_torch.ops.epipolar import recover_pose
from sfm_mvs_tpu_torch.ops.matching_cuda import knn_match_cuda
from sfm_mvs_tpu_torch.ops.sift import Features
from sfm_mvs_tpu_torch.utils.config import SfmConfig


class ViewGraph(NamedTuple):
    """Pairwise geometry. F frames, M pairs (all, or those within the window)."""

    pair_i: np.ndarray  # (M,) first frame index per pair
    pair_j: np.ndarray  # (M,) second frame index
    num_matches: np.ndarray  # (M,) ratio-test survivors
    num_inliers: np.ndarray  # (M,) E-RANSAC inliers
    R: np.ndarray  # (M, 3, 3) relative rotations
    t: np.ndarray  # (M, 3) relative translations (unit)
    adjacency: np.ndarray  # (F, F) symmetric inlier-count matrix
    parallax_deg: np.ndarray  # (M,) mean rotation-compensated ray angle


def _pair_geometry(gen, f0: Features, f1: Features, K, cfg: SfmConfig):
    """Match + E-RANSAC + pose + parallax for one pair. Returns
    (num_matches, num_inliers, R, t, parallax_deg) as device tensors."""
    fc, rc = cfg.frontend, cfg.ransac
    match = knn_match_cuda if fc.use_pallas_matcher else matching.knn_match
    m = match(f0.desc, f1.desc, f0.valid, f1.valid, ratio=fc.lowe_ratio)
    n0 = projection.normalize_points(f0.xy[m.idx0.long()], K)
    n1 = projection.normalize_points(f1.xy[m.idx1.long()], K)
    res = ransac.ransac_essential(gen, n0, n1, m.valid, 0.5 * (K[0, 0] + K[1, 1]),
                                  threshold_px=rc.essential_threshold_px,
                                  iters=rc.essential_iters)
    R, t, _ = recover_pose(res.model, n0, n1, res.inliers)

    # Parallax: mean angle between the rotation-compensated ray from view 0
    # and the matching ray in view 1, over inliers. A zero-baseline pair
    # (the degenerate-bootstrap trap) scores many E-inliers but ~0 here.
    def rays(n):
        h = torch.cat([n, torch.ones_like(n[:, :1])], dim=1)
        return h / torch.linalg.norm(h, dim=1, keepdim=True)

    cosang = torch.clamp((rays(n0) @ R.T * rays(n1)).sum(1), -1.0, 1.0)
    ang = torch.rad2deg(torch.arccos(cosang))
    wsum = torch.clamp_min(res.inliers.sum(), 1)
    parallax = torch.where(res.inliers, ang, torch.zeros_like(ang)).sum() / wsum
    return m.valid.sum(), res.num_inliers, R, t, parallax


def build_view_graph(images_gray: Sequence[np.ndarray], cfg: Optional[SfmConfig] = None,
                     seed: int = 0, batch_size: int = 8,
                     feats: Optional[list[Features]] = None, window: int = 0,
                     device="cuda") -> ViewGraph:
    """Match frame pairs: all of them, or those with |i - j| <= window.

    Features are detected on `device` (default ``cuda``; without a GPU pass
    ``device="cpu"``) unless given (then their device is used). Pairs run
    in batches of `batch_size` whose results reach the host in one
    transfer; the RANSAC draws come from one generator seeded with `seed`.
    """
    cfg = cfg or SfmConfig()
    if feats is None:
        dev = resolve_device(device)
        feats = [sift.detect_and_compute(torch.as_tensor(np.asarray(g, np.float32), device=dev),
                                         cfg.frontend) for g in images_gray]
    dev = feats[0].xy.device
    K = torch.as_tensor(cfg.intrinsic_matrix(), device=dev)
    F = len(feats)
    pairs = [(i, j) for i in range(F) for j in range(i + 1, F) if not window or j - i <= window]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = []
    for s in range(0, len(pairs), batch_size):
        batch = [_pair_geometry(gen, feats[i], feats[j], K, cfg)
                 for i, j in pairs[s:s + batch_size]]
        out.append([torch.stack(list(col)).cpu().numpy() for col in zip(*batch)])
    nm, ni, R, t, px = (np.concatenate(col) for col in zip(*out))
    adjacency = np.zeros((F, F), dtype=np.int32)
    for (i, j), n in zip(pairs, ni):
        adjacency[i, j] = adjacency[j, i] = n
    return ViewGraph(
        pair_i=np.asarray([p[0] for p in pairs]), pair_j=np.asarray([p[1] for p in pairs]),
        num_matches=nm.astype(np.int32), num_inliers=ni.astype(np.int32), R=R, t=t,
        adjacency=adjacency, parallax_deg=px)


def best_bootstrap_pair(graph: ViewGraph, min_inliers: int = 50,
                        min_parallax_deg: float = 1.0, max_gap: int = 0) -> tuple[int, int]:
    """Pick the strongest non-degenerate pair to initialize from.

    Among pairs with enough inliers AND enough parallax, the highest inlier
    count wins; the parallax floor relaxes to a quarter, then to zero, if
    no pair passes. max_gap > 0 restricts to pairs at most that many
    frames apart.
    """
    order = np.argsort(-graph.num_inliers)
    gaps = np.abs(graph.pair_j - graph.pair_i)
    for required_px in (min_parallax_deg, 0.25 * min_parallax_deg, 0.0):
        for idx in order:
            if max_gap and gaps[idx] > max_gap:
                continue
            if (graph.num_inliers[idx] >= min_inliers
                    and graph.parallax_deg[idx] >= required_px):
                return int(graph.pair_i[idx]), int(graph.pair_j[idx])
    idx = order[0]
    return int(graph.pair_i[idx]), int(graph.pair_j[idx])
