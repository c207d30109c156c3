"""k-means for PQ codebook learning, in plain PyTorch.

Counterpart of ``deltapq_tpu/ops/kmeans.py`` (XLA code in the JAX
package; no hand-written kernel here either).  kmeans++ seeding draws
from a ``torch.Generator`` where the JAX code takes a ``jax.random``
key, so the two packages learn different codebooks from the same data;
the Lloyd step itself (``_update_centers``, ``_reseed_empty``) is the
same arithmetic and is held against the JAX one in the tests.

Each subspace runs its own k-means (the JAX package vmaps them); the
M subspaces are few and every step is a batched device op.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import resolve_device
from .adc import no_tf32


def _pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [n, K] between x [n, d] and c [K, d]."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(c * c, dim=1)
    with no_tf32():
        xc = x @ c.T
    return x2 - 2.0 * xc + c2[None, :]


def _kmeanspp_init(gen: torch.Generator, x: torch.Tensor, K: int
                   ) -> torch.Tensor:
    """kmeans++ seeding: first center uniform, then each next center
    drawn with probability proportional to the squared distance to the
    nearest chosen center (uniform once every point is a center)."""
    n, d = x.shape
    first = int(torch.randint(0, n, (1,), generator=gen,
                              device=gen.device))
    centers = torch.zeros((K, d), dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    min_d2 = torch.sum((x - x[first]) ** 2, dim=1)
    for i in range(1, K):
        w = torch.where(min_d2.sum() > 0, torch.clamp_min(min_d2, 1e-30),
                        torch.ones_like(min_d2))
        idx = torch.multinomial(w, 1, generator=gen)
        c_new = x[idx[0]]
        centers[i] = c_new
        min_d2 = torch.minimum(min_d2, torch.sum((x - c_new) ** 2, dim=1))
    return centers


def _update_centers(x: torch.Tensor, labels: torch.Tensor, K: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean per cluster via a one-hot matmul (segment sum)."""
    onehot = torch.nn.functional.one_hot(labels, K).to(x.dtype)  # [n, K]
    counts = onehot.sum(dim=0)
    with no_tf32():
        sums = onehot.T @ x
    return sums / torch.clamp_min(counts, 1.0)[:, None], counts


def _reseed_empty(x: torch.Tensor, centers: torch.Tensor,
                  counts: torch.Tensor, min_d2: torch.Tensor
                  ) -> torch.Tensor:
    """Replace empty clusters' centers with the points farthest from
    their assigned center (deterministic)."""
    K = centers.shape[0]
    empty = counts == 0
    order = torch.cumsum(empty.to(torch.int64), dim=0) - 1
    far_idx = torch.argsort(-min_d2, stable=True)[:K]
    cand = x[far_idx][torch.clamp(order, 0, K - 1)]
    return torch.where(empty[:, None], cand, centers)


def _kmeans_single(gen: torch.Generator, x: torch.Tensor, K: int,
                   max_iters: int, tol: float):
    centers = _kmeanspp_init(gen, x, K)
    for _ in range(max_iters):
        d2 = _pairwise_sq_dists(x, centers)
        min_d2, labels = torch.min(d2, dim=1)
        new_centers, counts = _update_centers(x, labels, K)
        new_centers = _reseed_empty(x, new_centers, counts, min_d2)
        shift2 = torch.max(torch.sum((new_centers - centers) ** 2, dim=1))
        centers = new_centers
        if float(shift2) <= tol * tol:
            break
    d2 = _pairwise_sq_dists(x, centers)
    min_d2, labels = torch.min(d2, dim=1)
    return centers, labels, torch.sum(min_d2)


def kmeans(gen: torch.Generator, x: torch.Tensor, K: int,
           max_iters: int = 1000, tol: float = 1.0, n_init: int = 3):
    """k-means with ``n_init`` restarts; returns the best (centers
    [K, d], labels [n], distortion) by total distortion."""
    best = None
    for _ in range(n_init):
        res = _kmeans_single(gen, x, K, max_iters, tol)
        if best is None or float(res[2]) < float(best[2]):
            best = res
    return best


def _as_f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def pq_learn(gen: torch.Generator, vecs, M: int, K: int,
             max_iters: int = 1000, tol: float = 1.0, n_init: int = 3,
             device=None) -> torch.Tensor:
    """Learn a PQ codebook: codewords f32 [M, K, Ds] on ``device``.

    The (zero-padded) dimensions split into M contiguous slices, one
    k-means problem each.
    """
    x = _as_f32(vecs, resolve_device(device))
    n, D = x.shape
    pad = (-D) % M
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    Ds = (D + pad) // M
    sub = x.reshape(n, M, Ds).permute(1, 0, 2).contiguous()  # [M, n, Ds]
    return torch.stack([kmeans(gen, sub[m], K, max_iters, tol, n_init)[0]
                        for m in range(M)])
