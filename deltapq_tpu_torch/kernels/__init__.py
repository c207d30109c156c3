"""Build and load the CUDA kernels of ``deltapq_tpu_torch/csrc``."""
