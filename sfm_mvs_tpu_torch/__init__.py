"""sfm_mvs_tpu_torch — the PyTorch / CUDA port of sfm_mvs_tpu.

The same Structure-from-Motion and multi-view-stereo system as the JAX
package ``sfm_mvs_tpu`` (its reference), written in PyTorch for an NVIDIA
H100. The package imports ``torch`` and numpy only. It holds SIFT
detection, brute-force 2-NN matching with the Lowe ratio test (a
hand-written CUDA kernel on the GPU, ``csrc/knn2.cu``; MVS pass 1 has
its own, ``csrc/mvs_sweep.cu``), batched RANSAC
(essential, PnP, homography), the incremental driver (sequential or
view-graph bootstrap, per-frame or windowed bundle adjustment,
checkpoints and resume, finalize with loop closure, duplicate merging,
the densification sweep and BA of the intrinsics), the track-based global
pipeline, the KLT-tracking pipeline (pyramidal Lucas-Kanade), the
split-phase loop stitching (covisibility retrieval, batched
match-and-verify, re-apply after BA), plane-sweep MVS and the CLI
(``python -m sfm_mvs_tpu_torch``).

Subpackages mirror the JAX package's layout and names:

ops     Geometry and vision functions on tensors, plus the CUDA kernels.
models  Map store, bootstraps, incremental / global / KLT drivers, bundle
        adjustment, refinement, densification, stitching, MVS.
utils   Config (shared dataclasses), IO and checkpoints, evaluation,
        metrics, profiling, the device rule, synthetic scenes,
        visualization, conversion from the JAX package's state.
parallel  Process-group sharding (multi-GPU): the batched front end,
        distributed BA, the sharded map.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry needs genuine float32 products: under TF32 (the cuDNN default,
# and an option for matmuls) bundle adjustment stalls and pose solves skew
# (DESIGN.md §3). Every solve in the port is float32 end to end.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from sfm_mvs_tpu_torch.utils.config import SfmConfig  # noqa: E402,F401
