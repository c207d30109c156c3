"""Synthetic datasets for tests and the GPU smoke run.

Counterpart of ``deltapq_tpu/synth.py`` plus the benchmarks' workload
recipes (``bench.py``: ``WORKLOADS``, ``make_clustered_codes``;
``tools/bench_gist.py``: ``make_gist_workload``).  Vectors
come from NumPy generators seeded as in the JAX package; codebook
learning takes a ``torch.Generator`` where the JAX code takes a
``jax.random`` key, so the codebook differs between the packages while
the data does not.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import resolve_device

#: calibrated recipes (N=1M, M=8, K=256): (rows/cluster, noise sigma)
#: -> code duplication factor measured with the JAX pipeline
WORKLOADS = {
    "sift_like": dict(rows_per_cluster=8, sigma=0.8),    # dup ~1.06
    "moderate": dict(rows_per_cluster=16, sigma=0.35),   # dup ~2.0
    "dup_heavy": dict(rows_per_cluster=256, sigma=0.35),  # dup ~36.9
}


def chain_codes(n: int, M: int = 8, K: int = 256, seed: int = 0
                ) -> np.ndarray:
    """A chain of PQ codes, each differing from its predecessor in
    exactly one subspace (the best case for delta compression)."""
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if K <= 256 else np.uint16
    codes = np.empty((n, M), dtype)
    codes[0] = rng.integers(0, K, M)
    ms = rng.integers(0, M, n - 1)
    deltas = rng.integers(1, K, n - 1)
    for i in range(1, n):
        codes[i] = codes[i - 1]
        m = ms[i - 1]
        codes[i, m] = (int(codes[i, m]) + int(deltas[i - 1])) % K
    return codes


def clustered_codes(n: int, M: int = 8, K: int = 256, seed: int = 0,
                    rng=None) -> np.ndarray:
    """The engine benchmark's codes u8 [n, M]: a pool of max(n // 200,
    16) random codes, each row a pool member with 15% of its bytes
    redrawn.  ``rng`` continues a caller's generator (the benchmark draws
    its codewords first and its queries after), else one is made from
    ``seed``."""
    if rng is None:
        rng = np.random.default_rng(seed)
    pool = rng.integers(0, K, size=(max(n // 200, 16), M))
    codes = pool[rng.integers(0, len(pool), n)]
    mut = rng.random((n, M)) < 0.15
    return np.where(mut, rng.integers(0, K, size=(n, M)),
                    codes).astype(np.uint8)


def clustered_vectors(n: int, dim: int, n_clusters: int = 64,
                      spread: float = 1.0, scale: float = 4.0,
                      seed: int = 0) -> np.ndarray:
    """Gaussian mixture: PQ codes with heavy sharing."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * scale
    assign = rng.integers(0, n_clusters, n)
    return (centers[assign] +
            rng.normal(size=(n, dim)).astype(np.float32) * spread)


def workload_vectors(n: int, rows_per_cluster: int = 256,
                     sigma: float = 0.35, seed: int = 0,
                     D: int = 128) -> np.ndarray:
    """The benchmark's clustered vectors [n, D]: n/rows_per_cluster
    centers drawn normal x4, plus N(0, sigma^2) noise per row."""
    rng = np.random.default_rng(seed)
    n_clusters = max(n // rows_per_cluster, 1)
    centers = rng.normal(size=(n_clusters, D)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, size=n)
    return (centers[assign]
            + rng.normal(size=(n, D)).astype(np.float32) * sigma)


def make_clustered_codes(n: int, M: int, K: int,
                         rows_per_cluster: int = 256, sigma: float = 0.35,
                         seed: int = 0, device=None,
                         n_train: int = 20000
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Workload codes from the real pipeline: clustered vectors -> PQ
    learn on the first ``n_train`` rows (40 Lloyd iterations, one
    restart) -> encode.  Returns (codewords f32 [M, K, Ds], codes u8
    [n, M]), both on ``device``."""
    from .ops.encode import pq_encode
    from .ops.kmeans import pq_learn

    device = resolve_device(device)
    x = workload_vectors(n, rows_per_cluster, sigma, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    cw = pq_learn(gen, x[:n_train], M=M, K=K, max_iters=40, n_init=1,
                  device=device)
    codes = pq_encode(cw, x)
    return cw, codes


def gist_vectors(n: int, D: int = 960, n_clusters: int = 4096,
                 sigma: float = 0.35, seed: int = 0,
                 chunk_rows: int = 65536) -> np.ndarray:
    """The GIST-shape benchmark's clustered vectors f32 [n, D]:
    ``n_clusters`` centers drawn normal x4, each row a center plus
    N(0, sigma^2) noise.  The noise is drawn ``chunk_rows`` rows at a
    time, so no f64 [n, D] array is ever alive; consecutive draws of one
    generator give the values of a single draw, so the result does not
    depend on ``chunk_rows``."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, D)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, size=n)
    x = np.empty((n, D), np.float32)
    for r0 in range(0, n, chunk_rows):
        r1 = min(n, r0 + chunk_rows)
        x[r0:r1] = (centers[assign[r0:r1]]
                    + rng.normal(size=(r1 - r0, D)).astype(np.float32)
                    * sigma)
    return x


def make_gist_workload(n: int, M: int = 16, K: int = 256, Ds: int = 60,
                       n_clusters: int = 4096, seed: int = 0, device=None,
                       n_train: int = 20000
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The GIST1M-shaped workload from the real pipeline: clustered
    vectors of D = M*Ds dims (``gist_vectors``) -> PQ learn on the first
    ``n_train`` rows (40 Lloyd iterations, one restart) -> encode, both
    on ``device`` in batches.  Returns (codewords f32 [M, K, Ds], codes
    u8 [n, M] in database order, vectors f32 [n, D]) as NumPy arrays;
    the caller builds the DeltaTree for the scan order."""
    from .ops.encode import pq_encode
    from .ops.kmeans import pq_learn

    device = resolve_device(device)
    x = gist_vectors(n, M * Ds, n_clusters, seed=seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    cw = pq_learn(gen, x[:n_train], M=M, K=K, max_iters=40, n_init=1,
                  device=device)
    codes = pq_encode(cw, x, batch_size=65536)
    return cw.cpu().numpy(), codes.cpu().numpy(), x
