"""The benchmark of sfm_mvs_tpu_torch, the PyTorch and CUDA port: see README.md."""
