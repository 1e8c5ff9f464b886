"""Geometry and vision functions on tensors, and the CUDA 2-NN matcher."""
