"""DeltaTree layout: edges -> DFS-ordered structure-of-arrays.

A NumPy copy of ``deltapq_tpu/tree/layout.py``: parents from edges, the
per-node pruning bounds from the K x K inter-centroid tables
(``mkk_tables``, ``ancestor_max_dists``; zero in the light build,
``tables="skip"``), CSR adjacency with children ordered by descending
``max_dist2p`` (natural order in the light build) or by code, the
DFS numbering (the C++ ``dfs_layout`` of ``native/``, or the
explicit-stack Python loop when the library is unavailable), and
per-node diff lists vs the parent.  The tests hold every field equal to
the original's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..native import dfs_layout_native


@dataclass
class DeltaTree:
    """DFS-ordered DeltaTree (SoA).  Index 0 is the root pseudo-node."""

    vec_id: np.ndarray        # [N] uint32: database id at each DFS pos
    parent_pos: np.ndarray    # [N] int32: DFS pos of parent (-1 for root)
    depth: np.ndarray         # [N] uint8
    diff_num: np.ndarray      # [N] uint8 (root: M)
    diff_off: np.ndarray      # [N+1] int64 CSR offsets into diff arrays
    diff_m: np.ndarray        # [n_diffs_total] uint8 subspace index
    diff_to: np.ndarray       # [n_diffs_total] uint8/uint16 new centroid
    child_pos_start: np.ndarray  # [N] uint32
    child_num: np.ndarray     # [N] uint32: number of DFS descendants
    max_dist: np.ndarray      # [N] float32 (sqrt'd; zero in the light build)
    max_dist2p: np.ndarray    # [N] float32 (zero in the light build)
    root_id: int
    M: int
    K: int

    @property
    def n(self) -> int:
        return len(self.vec_id)

    def decode_codes(self) -> np.ndarray:
        """Reconstruct the full [N_db, M] code array (losslessness
        check): a node's code is its parent's with its diffs applied,
        level by level (parents precede children in DFS order).  The
        levels come from the parent pointers: the u8 ``depth`` wraps in a
        tree taller than 255 (an exact-MST tree of 65,536 rows), where
        the JAX method, which reads ``depth``, decodes wrongly and so
        feeds ``repair_tree`` wrong codes."""
        n = self.n
        codes = np.zeros((n, self.M), dtype=self.diff_to.dtype)
        depth = _depths(self.parent_pos)
        maxd = int(depth.max()) if n else 0
        for d in range(maxd + 1):
            sel = np.flatnonzero(depth == d)
            if d > 0:
                codes[sel] = codes[self.parent_pos[sel]]
            cnt = self.diff_num[sel].astype(np.int64)
            rows = np.repeat(sel, cnt)
            flat = _ragged_indices(self.diff_off[sel], cnt)
            codes[rows, self.diff_m[flat].astype(np.int64)] = \
                self.diff_to[flat]
        out = np.empty_like(codes)
        out[self.vec_id.astype(np.int64)] = codes
        return out


def _depths(parent_pos: np.ndarray) -> np.ndarray:
    """Exact int64 depth of every node from its parent pointer (-1 at
    the root), by pointer jumping: O(n log height)."""
    jump = parent_pos.astype(np.int64)
    depth = (jump >= 0).astype(np.int64)      # hops from a node to jump
    while True:
        live = np.flatnonzero(jump >= 0)
        if not len(live):
            return depth
        up = jump[live]
        depth[live] += depth[up]
        jump[live] = jump[up]


def _ragged_indices(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Flat indices [sum(counts)] enumerating starts[i]..starts[i]+counts[i]."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    rep_starts = np.repeat(starts.astype(np.int64), counts)
    offs = np.arange(total, dtype=np.int64) - \
        np.repeat(np.cumsum(counts) - counts, counts)
    return rep_starts + offs


def mkk_tables(codewords: np.ndarray) -> np.ndarray:
    """Inter-centroid squared-L2 tables [M, K, K]."""
    cw = np.asarray(codewords, np.float32)
    c2 = np.sum(cw * cw, axis=2)
    cross = np.einsum("mkd,mjd->mkj", cw, cw)
    return c2[:, :, None] - 2.0 * cross + c2[:, None, :]


def table_code_dists(tables: np.ndarray, codes: np.ndarray,
                     ids_a: np.ndarray, ids_b: np.ndarray) -> np.ndarray:
    """Approximate inter-code distance via the K x K tables."""
    M = codes.shape[1]
    out = np.zeros(len(ids_a), np.float32)
    ca = codes[ids_a]
    cb = codes[ids_b]
    for m in range(M):
        out += tables[m][ca[:, m].astype(np.int64),
                         cb[:, m].astype(np.int64)]
    return out


def ancestor_max_dists(codes: np.ndarray, parents: np.ndarray,
                       tables: np.ndarray, max_hops: int = 16):
    """Vectorized ancestor-chain walk: for every node v and each of its
    first ``max_hops`` ancestors a, ``max_dists[a] = max(.., d(v, a))``
    and ``max_dist2p[prev] = max(.., d(v, a))``, prev being the child of
    a on v's path."""
    n = len(parents)
    max_dists = np.zeros(n, np.float32)
    max_dist2p = np.zeros(n, np.float32)
    vids = np.arange(n, dtype=np.int64)
    prev = vids.copy()
    anc = parents.astype(np.int64)
    for _ in range(max_hops):
        mask = anc >= 0
        if not mask.any():
            break
        v = vids[mask]
        a = anc[mask]
        d = table_code_dists(tables, codes, v, a)
        np.maximum.at(max_dists, a, d)
        np.maximum.at(max_dist2p, prev[mask], d)
        prev = np.where(mask, anc, prev)
        anc = np.where(mask, parents[np.maximum(anc, 0)].astype(np.int64),
                       -1)
    return max_dists, max_dist2p


def _dfs_python(n, child_sorted, offsets, root_id):
    """Explicit-stack DFS over the CSR children: (dfs_vec, dfs_parent,
    dfs_depth), the order of the native ``dfs_layout``."""
    dfs_vec = np.empty(n, np.uint32)
    dfs_parent = np.empty(n, np.int32)
    dfs_depth = np.empty(n, np.uint8)
    pos_of = np.empty(n, np.int64)
    dfs_vec[0] = root_id
    dfs_parent[0] = -1
    dfs_depth[0] = 0
    pos_of[root_id] = 0
    idx = 1
    cur = offsets.copy()
    stack_arr = np.empty(n + 1, np.int64)
    sp = 0
    stack_arr[0] = root_id
    while sp >= 0:
        v = stack_arr[sp]
        if cur[v] < offsets[v + 1]:
            c = child_sorted[cur[v]]
            cur[v] += 1
            dfs_vec[idx] = c
            dfs_parent[idx] = pos_of[v]
            dfs_depth[idx] = dfs_depth[pos_of[v]] + 1
            pos_of[c] = idx
            idx += 1
            sp += 1
            stack_arr[sp] = c
        else:
            sp -= 1
    if idx != n:
        raise ValueError(f"forest not reachable from root: {idx} != {n}")
    return dfs_vec, dfs_parent, dfs_depth


def build_layout(codes: np.ndarray, edges: np.ndarray, root_id: int,
                 K: int, codewords: Optional[np.ndarray] = None,
                 tables=None, child_order: str = "dist") -> DeltaTree:
    """edges [E, 2] (parent, child) + root -> DFS SoA DeltaTree.

    tables: [M, K, K] inter-centroid distances (computed from
    ``codewords`` when None), or "skip" for the light build: zero
    pruning bounds and children in natural order.  child_order: "dist"
    = descending max_dist2p, "code" = lexicographic by child code.
    """
    codes = np.asarray(codes)
    n, M = codes.shape
    parents = np.full(n, -1, np.int64)
    if len(edges):
        parents[edges[:, 1].astype(np.int64)] = edges[:, 0]

    light = isinstance(tables, str) and tables == "skip"
    if tables is None:
        if codewords is None:
            raise ValueError("need codewords or precomputed mkk tables")
        tables = mkk_tables(codewords)
    if light:
        max_dists = np.zeros(n, np.float32)
        max_dist2p = np.zeros(n, np.float32)
    else:
        max_dists, max_dist2p = ancestor_max_dists(codes, parents, tables)

    # CSR adjacency with children sorted per child_order
    child = np.flatnonzero(parents >= 0)
    par = parents[child]
    if child_order == "code":
        ckeys = codes[child]
        order = np.lexsort(tuple(ckeys[:, m] for m in range(M - 1, -1, -1))
                           + (par,))
    else:
        order = np.lexsort((-max_dist2p[child], par))
    child_sorted = child[order]
    par_sorted = par[order]
    counts = np.bincount(par_sorted, minlength=n)
    offsets = np.concatenate([[0], np.cumsum(counts)])

    # the dfs_node_layout ordering: the C++ DFS (native/dtc_native.cpp),
    # or an explicit-stack Python loop when the library is unavailable
    native_out = dfs_layout_native(n, child_sorted.astype(np.uint32),
                                   offsets.astype(np.int64), int(root_id))
    if native_out is not None:
        dfs_vec, dfs_parent, dfs_depth = native_out[:3]
    else:
        dfs_vec, dfs_parent, dfs_depth = _dfs_python(n, child_sorted,
                                                     offsets, root_id)

    # child_pos_start / child_num: a DFS subtree of position i is the
    # positions i .. i + size - 1, so child_num is its size less one.
    # Sizes add up level by level from the deepest, over the exact
    # depths (the u8 depth wraps above 255)
    child_pos_start = np.arange(1, n + 1, dtype=np.uint32)
    depths = _depths(dfs_parent)
    by_depth = np.argsort(depths, kind="stable")
    level_ends = np.cumsum(np.bincount(depths))
    size = np.ones(n, np.int64)
    for hi, lo in zip(level_ends[:0:-1], level_ends[-2::-1]):
        lvl = by_depth[lo:hi]
        np.add.at(size, dfs_parent[lvl].astype(np.int64), size[lvl])
    child_num = (size - 1).astype(np.uint32)

    # diffs vs parent code, in subspace order; the root stores its full
    # code as M pseudo-diffs
    codes_dfs = codes[dfs_vec.astype(np.int64)]
    parent_codes = np.empty_like(codes_dfs)
    parent_codes[0] = 0
    parent_codes[1:] = codes_dfs[dfs_parent[1:].astype(np.int64)]
    diff_mask = codes_dfs != parent_codes
    diff_mask[0] = True
    diff_num = diff_mask.sum(axis=1).astype(np.uint8)
    diff_off = np.concatenate(
        [[0], np.cumsum(diff_num.astype(np.int64))])
    rows, cols = np.nonzero(diff_mask)
    at = dfs_vec.astype(np.int64)

    return DeltaTree(
        vec_id=dfs_vec, parent_pos=dfs_parent, depth=dfs_depth,
        diff_num=diff_num, diff_off=diff_off, diff_m=cols.astype(np.uint8),
        diff_to=codes_dfs[rows, cols], child_pos_start=child_pos_start,
        child_num=child_num, max_dist=np.sqrt(max_dists[at]),
        max_dist2p=np.sqrt(max_dist2p[at]), root_id=int(root_id), M=M, K=K)
