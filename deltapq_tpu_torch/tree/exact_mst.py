"""Exact-MST DeltaTree variant (union-find forest over diff rounds).

A NumPy copy of ``deltapq_tpu/tree/exact_mst.py``; the tests hold its
edges, root and diff count equal to the original's.

Behavioral re-implementation of the reference's exact path
(``create_tree.h``): ``find_edges_by_diff`` (``:771-826``) runs rounds
diff = 0..diff_argument of ``partition_linear_opt``
(``create_tree.h:188-303``): for every C(M, M-diff) kept-dimension
subset, hash all codes, sort, and link hash-equal neighbors whose
union-find components differ — producing a spanning forest whose edges
have weight <= diff, with early exit once N-1 edges are found
(``:807-810``).  Unlike the approximate star-forest path
(``tree/build.py``), every node keeps participating in later rounds
(union-find instead of active-set removal), so edge weights are
minimal-per-round — closer to a true MST at higher build cost.

The resulting edges feed the same ``build_layout`` / serialization
machinery as the approximate path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .build import EdgeFindResult, nchoosek, pack_keys


class _UnionFind:
    """Path-compressing union-find (reference ``find_set``,
    ``utils.cpp:151-163``), vectorized find for batches."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find_many(self, ids: np.ndarray) -> np.ndarray:
        p = self.parent
        roots = ids.astype(np.int64).copy()
        while True:
            pr = p[roots]
            done = pr == roots
            if done.all():
                break
            roots = pr
        # path compression
        p[ids] = roots
        return roots

    def union(self, a: int, b: int) -> bool:
        p = self.parent
        while p[a] != a:
            p[a] = p[p[a]]
            a = p[a]
        while p[b] != b:
            p[b] = p[p[b]]
            b = p[b]
        if a == b:
            return False
        p[b] = a
        return True


def find_edges_exact_mst(codes: np.ndarray, K: int,
                         diff_argument: Optional[int] = None
                         ) -> EdgeFindResult:
    """Spanning forest with per-round minimal diff weights."""
    codes = np.asarray(codes)
    n, M = codes.shape
    if diff_argument is None:
        diff_argument = M
    log_k = max(1, int(round(np.log2(K))))
    uf = _UnionFind(n)
    edges = []
    n_edges = 0

    for diff in range(diff_argument + 1):
        if n_edges >= n - 1:
            break
        for kept in nchoosek(M, M - diff):
            if n_edges >= n - 1:
                break
            keys = pack_keys(codes, kept, log_k)
            if keys.ndim == 1:
                order = np.argsort(keys, kind="stable")
                sk = keys[order]
                same = sk[1:] == sk[:-1]
            else:
                order = np.lexsort((keys[:, 1], keys[:, 0]))
                sk = keys[order]
                same = np.all(sk[1:] == sk[:-1], axis=1)
            # candidate pairs: adjacent in sort order with equal keys and
            # different components (parallel filter, serial commit —
            # create_tree.h:238-267)
            a = order[:-1][same]
            b = order[1:][same]
            if len(a) == 0:
                continue
            ra = uf.find_many(a)
            rb = uf.find_many(b)
            cand = np.flatnonzero(ra != rb)
            for j in cand:
                if uf.union(int(a[j]), int(b[j])):
                    edges.append((int(a[j]), int(b[j])))
                    n_edges += 1
                    if n_edges >= n - 1:
                        break

    edges_arr = (np.asarray(edges, np.uint32) if edges
                 else np.empty((0, 2), np.uint32))
    # root: representative of the (single) final component
    root_id = int(uf.find_many(np.array([0]))[0]) if n else -1
    # orient edges away from the root via BFS so (parent, child) holds
    if len(edges_arr):
        adj = [[] for _ in range(n)]
        for p, c in edges_arr:
            adj[p].append(c)
            adj[c].append(p)
        oriented = np.empty_like(edges_arr)
        seen = np.zeros(n, bool)
        stack = [root_id]
        seen[root_id] = True
        k = 0
        while stack:
            v = stack.pop()
            for w in adj[v]:
                if not seen[w]:
                    seen[w] = True
                    oriented[k] = (v, w)
                    k += 1
                    stack.append(w)
        edges_arr = oriented[:k]
    n_diffs = int(np.sum(codes[edges_arr[:, 0]] != codes[edges_arr[:, 1]])) \
        if len(edges_arr) else 0
    return EdgeFindResult(edges=edges_arr, root_id=root_id,
                          heights=np.zeros(n, np.int32), n_diffs=n_diffs,
                          finalists=np.empty(0, np.uint32))
