"""Groundtruth CSV I/O, byte-compatible with the reference.

A copy of ``deltapq_tpu/io/groundtruth.py``; the tests hold the bytes
equal both ways.

Format (``PQBase::write_groundtruth`` ``pqbase.cpp:294-315`` /
``read_groundtruth`` ``pqbase.cpp:316-332``): header line
``nq,topk``; then per query one line of ``id,dist,`` pairs sorted by
ascending distance.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def write_groundtruth(path: str, ids: np.ndarray, dists: np.ndarray) -> None:
    """ids/dists: [nq, topk]; rows are written sorted by distance."""
    ids = np.asarray(ids)
    dists = np.asarray(dists, dtype=np.float32)
    nq, topk = ids.shape
    order = np.argsort(dists, axis=1, kind="stable")
    ids = np.take_along_axis(ids, order, axis=1)
    dists = np.take_along_axis(dists, order, axis=1)
    with open(path, "w") as f:
        f.write(f"{nq},{topk}\n")
        for i in range(nq):
            f.write("".join(f"{int(a)},{float(d)}," for a, d in zip(ids[i], dists[i])))
            f.write("\n")


def read_groundtruth(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (ids [nq, topk] int64, dists [nq, topk] float32)."""
    with open(path) as f:
        nq, topk = (int(x) for x in f.readline().strip().rstrip(",").split(","))
        ids = np.empty((nq, topk), dtype=np.int64)
        dists = np.empty((nq, topk), dtype=np.float32)
        for i in range(nq):
            toks = f.readline().strip().rstrip(",").split(",")
            if len(toks) < 2 * topk:
                raise ValueError(f"{path}: query {i} has {len(toks)} tokens, want {2*topk}")
            ids[i] = [int(t) for t in toks[0::2][:topk]]
            dists[i] = [float(t) for t in toks[1::2][:topk]]
    return ids, dists


def write_scores(path: str, ids: np.ndarray, dists: np.ndarray) -> None:
    """Per-query (id, dist) text dump (reference ``WriteScores``,
    ``utils.cpp:118-138``)."""
    ids = np.asarray(ids)
    dists = np.asarray(dists)
    with open(path, "w") as f:
        for q in range(len(ids)):
            for a, d in zip(ids[q], dists[q]):
                f.write(f"{int(a)} {float(d)}\n")
            f.write("\n")
