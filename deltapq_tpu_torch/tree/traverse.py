"""Reference-semantics sequential DTC scan (host-side).

A NumPy copy of ``deltapq_tpu/tree/traverse.py``: the oracle the tests
hold the level-wise query (``ops/delta.py``) to.

Python mirror of ``query_processing_scan_compressed_codes_opt_in_memory``
(``deltapq_create_approx_tree.h:3731-3892``): walk the DFS stream with a
per-depth (code, distance) stack, double-precision distance accumulators
(``dists_stack`` is ``vector<double>``, ``:3773``), and a size-k
max-heap.  Used as the behavioral oracle for the level-wise query and for
cross-checking reference-produced DTC files.
"""

from __future__ import annotations

import heapq
from typing import List, Tuple

import numpy as np

from .serialize import deserialize_dtc


def scan_compressed(stream: np.ndarray, n_codes: int, M: int,
                    table: np.ndarray, top_k: int,
                    vec_id: np.ndarray = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Single-query scan of a DTC stream.

    table: [M, K] float ADC table for the query.  Returns (dists
    ascending [top_k], ids [top_k]); ids are DFS positions unless
    ``vec_id`` (DFS pos -> db id) is given.
    """
    depths, bitmaps, diff_to, diff_off = deserialize_dtc(stream, n_codes, M)
    lut = [np.flatnonzero([(b >> m) & 1 for m in range(8)])
           for b in range(256)]
    code_stack = np.zeros((18, M), np.int64)
    dist_stack = np.zeros(18, np.float64)

    root = diff_to[:M].astype(np.int64)
    code_stack[0] = root
    dist_stack[0] = float(np.sum(table[np.arange(M), root]))
    heap: List[Tuple[float, int]] = []  # max-heap via negation
    heapq.heappush(heap, (-dist_stack[0], 0))

    for i in range(1, n_codes):
        d = int(depths[i])
        row = code_stack[d - 1].copy()
        dist = dist_stack[d - 1]
        ms = lut[int(bitmaps[i])]
        s = diff_off[i]
        for j, m in enumerate(ms):
            to = int(diff_to[s + j])
            dist -= table[m, row[m]]
            dist += table[m, to]
            row[m] = to
        code_stack[d] = row
        dist_stack[d] = dist
        if len(heap) < top_k:
            heapq.heappush(heap, (-dist, i))
        elif dist < -heap[0][0]:
            heapq.heapreplace(heap, (-dist, i))

    items = sorted(((-nd, i) for nd, i in heap))
    dists = np.array([d for d, _ in items], np.float64)
    ids = np.array([i for _, i in items], np.int64)
    if vec_id is not None:
        ids = np.asarray(vec_id, np.int64)[ids]
    return dists, ids
