"""Tree re-rooting for the DTC depth limit.

A NumPy copy of the parts of ``deltapq_tpu/tree/reroot.py`` that
``serialize_dtc`` needs: ``reroot_min_height`` (the tree's center, found
with two BFS sweeps, is a minimum-height root) and ``repair_tree``,
which rebuilds a tree deeper than the DTC format's 4-bit depth nibble.
The tests hold its output equal to the original's.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _bfs_farthest(adj: List[List[int]], start: int
                  ) -> Tuple[int, np.ndarray]:
    n = len(adj)
    dist = np.full(n, -1, np.int64)
    dist[start] = 0
    frontier = [start]
    far = start
    while frontier:
        nxt = []
        for v in frontier:
            for w in adj[v]:
                if dist[w] < 0:
                    dist[w] = dist[v] + 1
                    nxt.append(w)
                    if dist[w] > dist[far]:
                        far = w
        frontier = nxt
    return far, dist


def reroot_min_height(edges: np.ndarray, n: int
                      ) -> Tuple[np.ndarray, int, int]:
    """Re-orient a tree's edges from its center.

    edges: [n-1, 2] (any orientation).  Returns (oriented edges
    (parent, child) from the new root, new_root, new_height).
    """
    adj: List[List[int]] = [[] for _ in range(n)]
    for a, b in np.asarray(edges, np.int64):
        adj[a].append(int(b))
        adj[b].append(int(a))
    u, _ = _bfs_farthest(adj, 0)
    v, dist_u = _bfs_farthest(adj, u)
    _, dist_v = _bfs_farthest(adj, v)
    diameter = dist_u[v]
    # center: the node on the u-v path with max(dist_u, dist_v) smallest
    on_path = dist_u + dist_v == diameter
    ecc = np.maximum(dist_u, dist_v)
    ecc[~on_path] = np.iinfo(np.int64).max
    center = int(np.argmin(ecc))
    new_height = int(ecc[center])

    oriented = np.empty((max(n - 1, 0), 2), np.uint32)
    seen = np.zeros(n, bool)
    seen[center] = True
    frontier = [center]
    k = 0
    while frontier:
        nxt = []
        for p in frontier:
            for c in adj[p]:
                if not seen[c]:
                    seen[c] = True
                    oriented[k] = (p, c)
                    k += 1
                    nxt.append(c)
        frontier = nxt
    return oriented[:k], center, new_height


def repair_tree(tree, max_depth: int = 15, codewords=None, tables=None):
    """Rebuild a too-deep DeltaTree so it fits the DTC depth nibble:
    center re-root, then, while the tree is still deeper than
    ``max_depth``, reparent the nodes below it to their grandparents
    (lossless: diffs are recomputed from the codes).  Returns a new
    DeltaTree over the same codes and ids."""
    from .layout import build_layout

    n = tree.n
    codes_db = tree.decode_codes()
    M = tree.M
    pos = np.arange(n)
    par = tree.parent_pos
    child_mask = par >= 0
    edges = np.stack([tree.vec_id[par[child_mask]],
                      tree.vec_id[pos[child_mask]]], axis=1)
    oriented, root, height = reroot_min_height(edges, n)
    if height > max_depth:
        parents = np.full(n, -1, np.int64)
        parents[oriented[:, 1].astype(np.int64)] = oriented[:, 0]
        while True:
            depth = np.zeros(n, np.int64)
            anc = parents.copy()
            while (anc >= 0).any():
                depth += anc >= 0
                anc = np.where(anc >= 0, parents[np.maximum(anc, 0)], -1)
            if depth.max() <= max_depth:
                break
            deep = depth > max_depth
            gp = parents[np.maximum(parents, 0)]
            parents = np.where(deep & (parents >= 0)
                               & (parents[np.maximum(parents, 0)] >= 0),
                               gp, parents)
        child = np.flatnonzero(parents >= 0)
        oriented = np.stack([parents[child], child], axis=1
                            ).astype(np.uint32)
    if tables is None and codewords is None:
        # zero tables keep the rebuild valid (the child order only
        # affects pruning, not the byte format)
        tables = np.zeros((M, tree.K, tree.K), np.float32)
    return build_layout(codes_db, oriented, root, K=tree.K,
                        codewords=codewords, tables=tables)
