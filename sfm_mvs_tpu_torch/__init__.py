"""sfm_mvs_tpu_torch — the PyTorch / CUDA port of sfm_mvs_tpu.

The same incremental Structure-from-Motion pipeline as the JAX package
``sfm_mvs_tpu`` (its reference), written in PyTorch for an NVIDIA H100:
SIFT detection, brute-force 2-NN matching with the Lowe ratio test (a
hand-written CUDA kernel on the GPU, ``csrc/knn2.cu``), the two-view
bootstrap and per-frame PnP registration with triangulation into a
fixed-capacity map. The package imports ``torch`` and numpy only.

Subpackages mirror the JAX package's layout and names:

ops     Geometry and vision functions on tensors, plus the CUDA matcher.
models  Map store, two-view bootstrap, incremental driver.
utils   Config (shared dataclasses), evaluation, synthetic scenes,
        conversion from the JAX package's state.
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
