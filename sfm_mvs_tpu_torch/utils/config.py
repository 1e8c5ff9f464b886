"""Configuration for the SfM pipeline.

A copy of ``sfm_mvs_tpu/utils/config.py`` (same dataclasses, fields and
defaults; importing the JAX package's copy would import jax).

The reference has no config system — all tunables are module globals one is
instructed to edit in-source (K at sfm.py:16, downscale sfm.py:19, img_dir
sfm.py:30, bundle_adjustment sfm.py:33, Lowe ratio sfm.py:264, RANSAC params
sfm.py:307, gtol sfm.py:337; README.md:12 says "edit Line 30"). Here every
tunable is a dataclass field with a CLI flag (see cli.py).

Capacity fields deserve a note: static shapes are kept, so feature
counts, match counts and map sizes are fixed capacities with validity masks
(SURVEY.md §7 "fixed-capacity, masked, batched state"). Defaults are sized
for the reference's Gustav sequence (57 images at 968x648).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Feature detection + matching (reference: sfm.py:242-270)."""

    # SIFT-style detector
    num_octaves: int = 4
    scales_per_octave: int = 3
    sigma0: float = 1.6
    upsample_input: bool = True  # double the image first, like OpenCV SIFT
    contrast_threshold: float = 0.04  # on [0,1] images; applied as thresh/scales_per_octave
    edge_threshold: float = 10.0
    max_features: int = 4096  # fixed capacity per image (top-K by response)
    descriptor_width: int = 4  # 4x4 spatial bins
    descriptor_bins: int = 8  # orientation bins -> 128-d descriptor
    # Gradient sampling for orientation/descriptor windows.
    # "nearest_polar": one gather per sample from a polar-gradient map
    #   quantized to (bf16 magnitude, bf16 angle) — OpenCV SIFT's
    #   per-pixel (uninterpolated) gradient use.
    # "bilinear": 4-corner bilinear interpolation of (dx, dy) maps.
    # The port implements both modes.
    grad_sampling: str = "nearest_polar"
    # Approximate per-octave top-k (lax.approx_max_k in the JAX package).
    # The port always selects with the exact torch.topk, which is what the
    # JAX package computes on CPU.
    approx_topk: bool = True
    # Matching: the fused 2-NN kernel (Pallas on TPU in the JAX package,
    # CUDA in the port) when set and mutual_check is off; the plain
    # matrix-product matcher otherwise. CPU tensors always use the plain
    # version.
    use_pallas_matcher: bool = True
    lowe_ratio: float = 0.70  # sfm.py:264
    mutual_check: bool = False  # reference BFMatcher.knnMatch is one-directional
    max_matches: int = 4096  # fixed capacity


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Vectorized RANSAC (replaces OpenCV RANSAC, sfm.py:307 / sfm.py:67)."""

    essential_iters: int = 2048  # hypothesis batch (vmapped, one shot)
    # Minimal solver: "8pt" (cheap; planar-degenerate, covered by the H/E
    # model selection in two_view.bootstrap) or "5pt" (Nister, the
    # reference's actual OpenCV solver — ops/five_point.py; each sample
    # yields up to 10 hypotheses, so effective batch is 10x iters).
    essential_solver: str = "8pt"
    # 2px accommodates the detector's subpixel noise at small baselines
    # (measured: a 1px threshold collapses 134 matches to 2 inliers on an
    # 8-degree pair; 2px keeps 127). The weighted refits + pose recovery +
    # downstream PnP thresholds still enforce geometric quality.
    essential_threshold_px: float = 2.0
    pnp_iters: int = 1024
    pnp_threshold_px: float = 4.0
    # Add a 3-point Grunert P3P hypothesis family (ops/p3p.py) alongside
    # the 6-point DLT + planar solvers: all-inlier sample odds are w^3 vs
    # w^6, which dominates on contaminated 2D-3D correspondence sets.
    pnp_use_p3p: bool = True
    # Loop-closure / stitch verification: a pair's epipolar E-RANSAC must
    # keep at least this many inliers before its matches are trusted
    # (guards against spurious far pairs with degenerate E). Hoisted here
    # so the driver and benchmarks can't drift apart (advisor r3).
    stitch_min_inliers: int = 16
    # Degenerate-frame guard (the domain's failure detection, SURVEY.md §5;
    # the germ exists in the reference at test.py:254-255 "Less features!").
    # A frame whose PnP lands below this many inliers is REJECTED: the map
    # is left untouched and the sliding window keeps the previous frame.
    min_pnp_inliers: int = 12
    # Re-observation merging: before creating a new 3D point, check whether
    # a recently-created map point projects to (almost) the same pixel in
    # the new camera with consistent depth — if so, extend that point's
    # track instead of duplicating it. (The reference's frame-to-frame
    # association can only continue consecutive tracks, so every
    # re-detection after a gap duplicates the point.)
    merge_reobservations: bool = True
    merge_px: float = 2.0  # pixel radius for re-observation matching
    merge_depth_rel: float = 0.1  # relative depth agreement
    merge_window: int = 8192  # how many recent map points to test against
    homography_iters: int = 1024
    homography_threshold_px: float = 4.0
    refit_rounds: int = 2  # inlier-weighted refits after hypothesis selection
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class BaConfig:
    """Sparse-Schur Levenberg-Marquardt bundle adjustment.

    Replaces the reference's dense finite-difference TRF (sfm.py:104-157);
    parameterization follows its notebook prototype (cameras 6-dof + points,
    observations fixed) — not sfm.py's defective pack that optimizes the 2D
    observations and K jointly (sfm.py:141-143).
    """

    enabled: bool = False  # reference default: bundle_adjustment=False (sfm.py:33)
    max_iterations: int = 20
    cadence: int = 1  # run BA every K registered frames
    huber_delta: float = 0.0  # >0: Huber-robustified residuals (pixels)
    damping_init: float = 1e-3
    damping_up: float = 4.0
    damping_down: float = 2.0
    # 0 = global BA every cadence; else sliding-window BA over the last K
    # cameras as a STATIC-SHAPE sub-problem (ba.bundle_adjust_window) —
    # per-frame cost O(window_points * K), independent of map capacity.
    # The windowed path is what keeps long sequences (250+ cameras) at
    # registration speed; finalize() still runs the full global BA.
    local_window: int = 0
    window_points: int = 16384  # point-axis extent of the windowed BA
    # Refine the shared [focal_scale, k1, k2] block during the FINAL
    # global BA (the notebook prototype's f/k1/k2 camera params,
    # checkpoint cells 3-7). Off by default: the reference pipeline
    # trusts its calibrated K (sfm.py:16).
    refine_intrinsics: bool = False
    # Per-CAMERA (f, k1, k2) instead of one shared block — the notebook
    # prototype's exact 9-param camera (checkpoint cells 3-7). Recovered
    # intrinsics are reported in finalize_info (they cannot fold into the
    # single shared K).
    refine_intrinsics_per_camera: bool = False


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Final densification sweep (reference semantics: the accumulate-
    everything loop sfm.py:387-395 / the test.py final sweep test.py:339-380).

    After all poses are registered and bundle-adjusted, every adjacent
    frame pair is re-matched and ALL ratio-surviving matches that
    triangulate cleanly are appended to the cloud (deduplicated against
    the map by projected pixel distance + depth agreement). This recovers
    the reference's cloud density (19,282 points on Gustav) that the
    registration loop's conservative track management intentionally
    avoids carrying through per-frame BA.
    """

    enabled: bool = False
    reproj_px: float = 1.5  # both-view reprojection gate for new points
    dedup_px: float = 1.0  # projected-pixel radius for map duplicates
    dedup_depth_rel: float = 0.05  # relative depth agreement for duplicates
    grow_points: int = 65_536  # enlarge the map to this capacity first
    pair_strides: Tuple[int, ...] = (1,)  # sweep pairs (i, i+s) per stride s
    final_ba_iters: int = 8  # polish BA after the sweep (0 = skip)
    # Sweep-time re-detection: the registration loop runs a right-sized
    # feature budget (detection is its per-frame bottleneck); the one-time
    # sweep can afford a much denser budget. 0 = reuse the run's features.
    max_features: int = 0
    contrast_threshold: float = 0.0  # 0 = inherit frontend's
    lowe_ratio: float = 0.0  # 0 = inherit frontend's


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Fixed-capacity map store (SURVEY.md §7 item 4)."""

    max_cameras: int = 64
    max_points: int = 131_072
    # Observations are a dense (max_points, max_cameras) grid (one slot per
    # point-camera pair), so obs capacity is implied by the two above.

    # Loose sanity gate (px) for epipolar-verified stitch injections: on a
    # drifted map the strict map-agreement gate rejects exactly the
    # drift-revealing matches, so stitching uses pair-local E-RANSAC plus
    # this bound. Hoisted from hard-coded 64.0 px (advisor r3).
    stitch_gate_px: float = 64.0


@dataclasses.dataclass(frozen=True)
class SfmConfig:
    """Top-level pipeline configuration."""

    # Intrinsics: fx, fy, cx, cy, skew (reference hardcodes K at sfm.py:16)
    fx: float = 2393.952166119461
    fy: float = 2398.118540286656
    cx: float = 932.3821770809047
    cy: float = 628.2649953288065
    skew: float = 0.0
    # Radial distortion (k1, k2) — the reference threads these through
    # cv2.solvePnPRansac/projectPoints (sfm.py:67,88; the notebook's
    # camera model is (rvec, t, f, k1, k2)). Nonzero values undistort
    # detected keypoints at the front door (projection.undistort_pixels),
    # making every downstream stage pinhole-consistent.
    k1: float = 0.0
    k2: float = 0.0
    downscale: int = 2  # powers of two, divides K (sfm.py:19-23)

    image_dir: str = ""
    output_dir: str = "Point_Cloud"
    max_images: Optional[int] = None

    # Bootstrap pair selection: "seq" = frames (0, 1) exactly like the
    # reference (sfm.py:300-302); "auto" = the strongest sufficient-
    # parallax pair from the view graph (the completed isfm.py), with
    # registration walking outward from it.
    bootstrap: str = "seq"
    # Inject re-observations from the top-K strong NON-adjacent view-graph
    # pairs before the final BA (loop closures). 0 = off.
    loop_close_pairs: int = 0
    # Pair window for the bootstrap view graph (0 = exhaustive O(N^2)).
    view_graph_window: int = 8

    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    ransac: RansacConfig = dataclasses.field(default_factory=RansacConfig)
    ba: BaConfig = dataclasses.field(default_factory=BaConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    sweep: SweepConfig = dataclasses.field(default_factory=SweepConfig)

    # Cloud export semantics (sfm.py:170-181): x200 scale, mean+300 cutoff.
    ply_scale: float = 200.0
    ply_outlier_offset: float = 300.0

    # Sharding
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)

    def intrinsic_matrix(self) -> np.ndarray:
        """K after downscale division (reference sfm.py:19-23)."""
        d = float(self.downscale)
        return np.array(
            [
                [self.fx / d, self.skew, self.cx / d],
                [0.0, self.fy / d, self.cy / d],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float32,
        )

    @staticmethod
    def for_gustav() -> "SfmConfig":
        """Reference-equivalent configuration for the Gustav sequence."""
        return SfmConfig()
