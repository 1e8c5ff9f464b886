"""Geometry and vision functions on tensors, the CUDA 2-NN matcher and
MVS pass 1's CUDA kernels."""
