"""deltapq-tpu's PyTorch + CUDA port, for NVIDIA Hopper (H100).

The JAX package ``deltapq_tpu`` stays the reference; this package grows
beside it with the same sub-layout and the same module and function
names.  It imports ``torch`` and ``numpy``, never ``jax``.  Each kernel
the JAX package wrote in Pallas becomes a hand-written CUDA kernel
(``csrc/``, built by ``kernels/build.py`` at first use), with a plain
PyTorch version beside it in the same module.

Ported so far: the ``index.DeltaPQIndex`` API and every tier it routes
to on one card -- the compressed-stream engine (int8, int16 and bf16),
the codes, decoded and dedup tiers and ``query_plain`` -- the big-N path,
the plain-scan engine family (ADC distance matrix, argmin, packed and
tile-dictionary top-k, the decoded-cache engine), with PQ learn/encode,
the DeltaTree build, DFS layout and DTC serialization, and the stream
and slot tiles.

Every entry point takes ``device=None``, which means the card
(``resolve_device``); the CPU is used only when the caller names it.

- ``deltapq_tpu_torch.index``   ``DeltaPQIndex``: build, search, add,
                                remove, compact, stats, save, load
- ``deltapq_tpu_torch.ops``     ADC, k-means, encode, stream tiles, the
                                decoded cache and engine, scan kernels
                                + epilogue, the ADC lookup kernels, the
                                engines
- ``deltapq_tpu_torch.eval``    exact groundtruth and retrieval metrics
- ``deltapq_tpu_torch.bench_engines``  every plain-scan engine, timed
- ``deltapq_tpu_torch.tree``    DeltaTree edges, layout, re-rooting,
                                DTC serialization
- ``deltapq_tpu_torch.kernels`` nvcc build + ctypes loader
- ``deltapq_tpu_torch.convert`` engine and index state from the JAX
                                package
"""

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` is the card,
    ``torch.device("cuda")``, whether or not one is present (without one
    the first tensor placed there raises); anything else is taken as
    given.  The CPU is used only when the caller names it."""
    return torch.device("cuda" if device is None else device)
