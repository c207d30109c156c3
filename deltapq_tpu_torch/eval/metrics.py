"""Evaluation metrics matching the reference's ``recall`` / ``mAP`` /
``accuracy`` tasks.

A NumPy copy of ``deltapq_tpu/eval/metrics.py`` (that module imports no
JAX, but the port keeps its own copy of what it needs); the tests hold
the results equal.  ``top1_accuracy`` implements the obvious intent of
the reference's ``accuracy`` task (top-1 of the approximate search is
the true nearest neighbor); all other formulas mirror the reference.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def recall_at_k(retrieved_ids: np.ndarray, gt_ids: np.ndarray,
                k: Optional[int] = None) -> float:
    """Mean |retrieved@k ∩ gt@k| / k (reference ``recall`` task,
    ``main.cpp:782-796``)."""
    if k is None:
        k = retrieved_ids.shape[1]
    r = retrieved_ids[:, :k].astype(np.int64)
    g = gt_ids[:, :k].astype(np.int64)
    # vectorized per-row set intersection: disambiguate rows by offset
    # keys (ids are bounded), then one flat isin pass
    off = (np.arange(len(r), dtype=np.int64)
           * (max(int(r.max(initial=0)), int(g.max(initial=0))) + 2)
           )[:, None]
    hits = int(np.isin((r + off).ravel(), (g + off).ravel()).sum())
    return hits / (len(r) * k)


def top1_accuracy(retrieved_ids: np.ndarray, gt_ids: np.ndarray) -> float:
    """Fraction of queries whose first result is the true NN (intended
    semantics of the broken ``accuracy`` task, ``main.cpp:670-726``)."""
    return float(np.mean(retrieved_ids[:, 0] == gt_ids[:, 0]))


def mean_average_precision(retrieved_ids: np.ndarray, gt_ids: np.ndarray,
                           retrieved_dists: Optional[np.ndarray] = None,
                           gt_dists: Optional[np.ndarray] = None
                           ) -> Dict[str, float]:
    """mAP@k plus the distance-ratio statistics of the ``mAP`` task
    (``main.cpp:863-896``).

    AP@k for one query = (1/topk) * sum_{k=1..topk} |ret@k ∩ gt@k| / k.
    avg/max ratio compare sqrt(gt_dist_k) / sqrt(retrieved_dist_k)
    position-wise (reference ``main.cpp:869-874``).
    """
    nq, topk = retrieved_ids.shape
    have_ratio = retrieved_dists is not None and gt_dists is not None
    # prefix-intersection sizes for every k at once:
    # score_k[q] = # (i < k, j < k) with r[q,i] == g[q,j], read off the
    # diagonal of the 2-D cumulative sum of the match matrix.  Chunked
    # over queries to bound the [chunk, topk, topk] working set.
    total = 0.0
    chunk = max(1, 16_000_000 // max(topk * topk, 1))
    inv_k = 1.0 / np.arange(1, topk + 1)
    for s0 in range(0, nq, chunk):
        r = retrieved_ids[s0:s0 + chunk]
        g = gt_ids[s0:s0 + chunk]
        match = (r[:, :, None] == g[:, None, :])
        scores = match.cumsum(axis=1).cumsum(axis=2)
        diag = scores[:, np.arange(topk), np.arange(topk)]  # [c, topk]
        total += float((diag * inv_k[None, :]).sum()) / topk
    out = {"mAP": total / nq}
    if have_ratio:
        rk = np.sqrt(np.maximum(retrieved_dists, 0.0))
        gk = np.sqrt(np.maximum(gt_dists, 0.0))
        ratio = np.where(rk > 0, gk / np.where(rk > 0, rk, 1.0), 0.0)
        out["avg_ratio"] = float(ratio.mean())
        out["max_ratio"] = float(ratio.max(initial=0.0))
    return out


def epsilon_recall(retrieved_true_dists: np.ndarray, gt_dists: np.ndarray,
                   eps: float = 1.1) -> Dict[str, float]:
    """ε-recall / true-distance recall / k-approximation ratio
    (reference ``main.cpp:898-940``).

    retrieved_true_dists: TRUE squared-L2 distances of the retrieved ids
    (the reference re-reads raw base vectors by seek offset); gt_dists:
    squared-L2 of the exact top-k.  All compared in sqrt space.
    """
    nq, topk = retrieved_true_dists.shape
    rd = np.sqrt(np.maximum(retrieved_true_dists, 0.0))
    kth = np.sqrt(np.maximum(gt_dists[:, topk - 1], 0.0))  # [nq]
    thres = kth * eps
    rec_eps = float(np.mean(rd <= thres[:, None]))
    rec = float(np.mean(rd <= kth[:, None]))
    valid = kth > 0
    ratio = float(np.mean(rd[valid].max(axis=1) / kth[valid])) \
        if valid.any() else 0.0
    return {"eps_recall": rec_eps, "recall_true": rec, "k_app_ratio": ratio}


def true_distances(base: np.ndarray, queries: np.ndarray,
                   ids: np.ndarray) -> np.ndarray:
    """Squared-L2 between each query and its retrieved base vectors
    (reference re-reads base vectors by offset, ``main.cpp:901-931``)."""
    nq, topk = ids.shape
    out = np.empty((nq, topk), np.float32)
    # chunk so the [chunk, topk, D] gather stays bounded
    chunk = max(1, 64_000_000 // max(topk * base.shape[1] * 4, 1))
    for s0 in range(0, nq, chunk):
        sel = ids[s0:s0 + chunk]
        diff = base[sel] - queries[s0:s0 + chunk, None, :]
        out[s0:s0 + chunk] = np.sum(diff * diff, axis=2)
    return out


def code_hamming_hist(query_codes: np.ndarray, nn_codes: np.ndarray,
                      M: Optional[int] = None) -> np.ndarray:
    """Histogram over 0..M of the subspace Hamming distance between each
    query's PQ code and its nearest neighbor's code (reference
    ``SampledQuery`` ``dist_hist``, ``pq_tree.cpp:278-392`` /
    ``main.cpp:541-562``)."""
    if M is None:
        M = query_codes.shape[1]
    h = (query_codes != nn_codes).sum(axis=1)
    return np.bincount(h, minlength=M + 1)
