"""Data-parallel front end: batched feature detection and pair matching.

PyTorch port of ``sfm_mvs_tpu/parallel/frontend.py``. Frames are the
embarrassingly parallel axis of SfM: a batch of images is split over the
ranks, each rank runs the batched SIFT stack (``sift.detect_batch``) on its
share, and an all-gather brings every frame's features to every rank.
Pair matching splits the same way over the pair axis, each rank's share
in one batched K1 launch (``matching.match_with_config`` on a stack of
pairs).
"""

from __future__ import annotations

import torch

from sfm_mvs_tpu_torch.ops import matching, sift
from sfm_mvs_tpu_torch.ops.sift import Features
from sfm_mvs_tpu_torch.parallel.mesh import all_gather, as_mesh, block
from sfm_mvs_tpu_torch.utils.config import FrontendConfig


def detect_batch(images: torch.Tensor, cfg: FrontendConfig) -> Features:
    """SIFT over a batch of images: (B, H, W) -> Features with a leading
    batch axis (the JAX package's vmapped detector)."""
    return sift.detect_batch(images, cfg)


def match_batch(desc0: torch.Tensor, desc1: torch.Tensor, valid0: torch.Tensor,
                valid1: torch.Tensor, ratio: float = 0.70,
                mutual: bool = False) -> matching.Matches:
    """KNN-match a batch of descriptor pairs, desc*: (B, N, D). Without the
    mutual check, one batched K1 launch on CUDA tensors (the plain batched
    matcher on CPU tensors); with it, the plain batched matcher."""
    if mutual:
        return matching.knn_match(desc0, desc1, valid0, valid1, ratio, mutual=True)
    from sfm_mvs_tpu_torch.ops.matching_cuda import knn_match_cuda_batch

    return knn_match_cuda_batch(desc0, desc1, valid0, valid1, ratio)


def _gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's (b, ...) block of a leading axis, concatenated in rank
    order: (W b, ...)."""
    g = all_gather(x, mesh)
    return g.reshape((-1,) + tuple(x.shape[1:]))


def detect_batch_sharded(images: torch.Tensor, cfg: FrontendConfig, mesh) -> Features:
    """Detect a batch of frames split over the ranks.

    images: (B, H, W), the same on every rank, B divisible by the rank
    count. Each rank detects its B/W frames in one ``detect_batch``, then
    an all-gather of every Features field gives each rank the whole batch.
    """
    mesh = as_mesh(mesh)
    mine = detect_batch(images[block(images.shape[0], mesh)], cfg)
    return Features(*[_gather_rows(f, mesh) for f in mine])


def match_pairs_sharded(feats: Features, pair_idx0: torch.Tensor, pair_idx1: torch.Tensor,
                        mesh, cfg: FrontendConfig) -> matching.Matches:
    """Match a batch of (i, j) frame pairs, split over the pair axis.

    feats: batched Features (B frames, the same on every rank);
    pair_idx0/1: (M,) frame indices per pair, M divisible by the rank
    count. Each rank stacks its M/W pairs' descriptors and matches them in
    one ``match_with_config`` call (one batched K1 launch unless the
    config asks for the mutual check or the plain matcher), then an
    all-gather returns all M rows (M, N) to every rank.
    """
    mesh = as_mesh(mesh)
    sl = block(pair_idx0.shape[0], mesh)
    i0 = pair_idx0[sl].to(feats.desc.device).long()
    i1 = pair_idx1[sl].to(feats.desc.device).long()
    m = matching.match_with_config(feats.desc[i0], feats.desc[i1], feats.valid[i0],
                                   feats.valid[i1], cfg)
    return matching.Matches(*[_gather_rows(f, mesh) for f in m])
