"""Compute ops of the port (PyTorch; CUDA kernels in ``fused_kernels``)."""
