"""deltapq-tpu's PyTorch + CUDA port, for NVIDIA Hopper (H100).

The JAX package ``deltapq_tpu`` stays the reference; this package grows
beside it with the same sub-layout and the same module and function
names.  It imports ``torch`` and ``numpy``, never ``jax``.  Each kernel
the JAX package wrote in Pallas becomes a hand-written CUDA kernel
(``csrc/``, built by ``kernels/build.py`` at first use), with a plain
PyTorch version beside it in the same module.

Ported so far: the ``index.DeltaPQIndex`` API and every tier it routes
to on one card -- the compressed-stream engine (int16 and bf16), the
codes, decoded and dedup tiers and ``query_plain`` -- with PQ
learn/encode, the DeltaTree build, DFS layout and DTC serialization,
and the tile builder.

- ``deltapq_tpu_torch.index``   ``DeltaPQIndex``: build, search, add,
                                remove, compact, stats, save, load
- ``deltapq_tpu_torch.ops``     ADC, k-means, encode, stream tiles, the
                                decoded cache, scan kernels + epilogue,
                                the ADC top-k kernel, the engines
- ``deltapq_tpu_torch.tree``    DeltaTree edges, layout, re-rooting,
                                DTC serialization
- ``deltapq_tpu_torch.kernels`` nvcc build + ctypes loader
- ``deltapq_tpu_torch.convert`` engine and index state from the JAX
                                package
"""

__version__ = "0.1.0"
