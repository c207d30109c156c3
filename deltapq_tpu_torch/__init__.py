"""deltapq-tpu's PyTorch + CUDA port, for NVIDIA Hopper (H100).

The JAX package ``deltapq_tpu`` stays the reference; this package grows
beside it with the same sub-layout and the same module and function
names.  It imports ``torch`` and ``numpy``, never ``jax``.  Each kernel
the JAX package wrote in Pallas becomes a hand-written CUDA kernel
(``csrc/``, built by ``kernels/build.py`` at first use), with a plain
PyTorch version beside it in the same module.

Ported so far: the compressed-stream query path at int16 --
``ops.fused.FusedCompressedEngine`` over stream tiles in DeltaTree-DFS
order, with PQ learn/encode, the DeltaTree build and the tile builder.

- ``deltapq_tpu_torch.ops``     ADC, k-means, encode, stream tiles,
                                scan kernels + epilogue, the engine
- ``deltapq_tpu_torch.tree``    DeltaTree edge finding and DFS layout
- ``deltapq_tpu_torch.kernels`` nvcc build + ctypes loader
- ``deltapq_tpu_torch.convert`` engine state from the JAX package
"""

__version__ = "0.1.0"
