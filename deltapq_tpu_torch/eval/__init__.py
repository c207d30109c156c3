"""Evaluation: exact groundtruth and the retrieval metrics.

Counterpart of ``deltapq_tpu/eval``.  ``groundtruth_from_file`` is not
ported yet (it reads TEXMEX files through ``io/``, ROADMAP A).
"""

from typing import Dict

import numpy as np

from .groundtruth import exact_topk
from .metrics import (epsilon_recall, mean_average_precision, recall_at_k,
                      top1_accuracy, true_distances)

__all__ = [
    "exact_topk", "recall_at_k", "top1_accuracy", "mean_average_precision",
    "epsilon_recall", "true_distances", "evaluate",
]


def evaluate(retrieved_ids, retrieved_dists, gt_ids, gt_dists,
             base=None, queries=None, eps: float = 1.1) -> Dict[str, float]:
    """One-call evaluation bundle: recall@k, top-1 accuracy, mAP +
    ratios, and (when raw base vectors are given) true-distance
    eps-recall."""
    out = {"recall_at_k": recall_at_k(retrieved_ids, gt_ids),
           "top1_accuracy": top1_accuracy(retrieved_ids, gt_ids)}
    out.update(mean_average_precision(retrieved_ids, gt_ids,
                                      retrieved_dists, gt_dists))
    if base is not None and queries is not None:
        td = true_distances(np.asarray(base), np.asarray(queries),
                            retrieved_ids)
        out.update(epsilon_recall(td, gt_dists, eps))
    return out
