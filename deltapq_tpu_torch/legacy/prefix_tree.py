"""Legacy bit-interleaved store + prefix-tree query (non-PLAIN_PQ path).

A copy of ``deltapq_tpu/legacy/prefix_tree.py``: NumPy throughout, but
``dichotomize_codewords``, whose 2-means runs the port's
``ops.kmeans.kmeans`` on a device.  The tests hold the bytes, the query
results and the statistics equal to the original's.

The reference's abandoned pre-DeltaPQ experiment (compiled only when
``PLAIN_PQ`` is off, ``pq_tree.h:14``): codes are stored
**bit-interleaved** into 64-bit words (``BitVecs``, ``pq_tree.h:25-59``;
``Encode`` bit layout ``pq_tree.cpp:168-175``), the store is sorted by
that word (``SortVecs``, ``pq_tree.cpp:1193-1198``), codewords are
re-ordered by recursive 2-means so that centroid-id bit prefixes track
spatial proximity (``DichotomizeCodewords``, ``pq_tree.cpp:86-128``),
and queries run branch-and-bound over centroid-bit prefixes with
hierarchical min/max bound tables (``Query``/``BuildTree``/
``ScanLeaves``, ``pq_tree.cpp:552-979``).

This module is the behavioral equivalent, vectorized:

* interleaving is 8 shift/or passes over the whole code array;
* the hierarchical bounds (``m_sub_bounds``) are reshape+min/max
  pyramids;
* the branch-and-bound expands one prefix LEVEL at a time over all
  surviving nodes as arrays (the recursion only crosses levels), with
  leaf ranges located by ``np.searchsorted`` on the sorted words.

Semantics notes vs the reference kept intentionally: the query answers
**top-1** (the reference fills ``results[0]`` only); pruning uses
``lower_bound < bound * (1 + EPS)`` with EPS = 0.2
(``pq_tree.h:18``-era constant in ``deltapq_create_approx_tree.h:40``).
Deviation: the initial upper bound is the ADC distance of the
prefix-matched row (the reference seeds with the *raw-vector* distance
of that row, mixing metric domains — with the ADC seed the returned
top-1 provably equals the plain ADC scan's).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device

EPS = 0.2  # reference pruning slack (deltapq_create_approx_tree.h:40)


def interleave_codes(codes: np.ndarray, log_k: int = 8) -> np.ndarray:
    """[N, M] codes -> [N] uint64 bit-interleaved words.

    Bit ``j`` of subspace ``i`` lands at position ``(M-1-i) + j*M``
    (``pq_tree.cpp:168-175``): significance-major interleave, subspace
    0 most significant within each bit level.
    """
    codes = np.asarray(codes)
    n, M = codes.shape
    out = np.zeros(n, np.uint64)
    c = codes.astype(np.uint64)
    for i in range(M):
        for j in range(log_k):
            bit = (c[:, i] >> np.uint64(j)) & np.uint64(1)
            out |= bit << np.uint64((M - 1 - i) + j * M)
    return out


def deinterleave_codes(words: np.ndarray, M: int, log_k: int = 8
                       ) -> np.ndarray:
    """Inverse of ``interleave_codes``."""
    words = np.asarray(words, np.uint64)
    out = np.zeros((len(words), M), np.uint16 if log_k > 8 else np.uint8)
    for i in range(M):
        for j in range(log_k):
            bit = (words >> np.uint64((M - 1 - i) + j * M)) & np.uint64(1)
            out[:, i] |= (bit << np.uint64(j)).astype(out.dtype)
    return out


class BitVecsStore:
    """Sorted bit-interleaved code store (``BitVecs`` equivalent).

    Binary I/O matches the reference: ``int32 N, int32 D`` then N
    8-byte words (``BitVecs::Write``, ``pq_tree.cpp:1132-1152``).
    ``ids[r]`` maps a sorted row back to its database id (the reference
    loses this mapping — its prefix query reports sorted positions).
    """

    def __init__(self, codes: np.ndarray, log_k: int = 8,
                 sort: bool = True):
        codes = np.asarray(codes)
        self.M = codes.shape[1]
        self.log_k = log_k
        words = interleave_codes(codes, log_k)
        if sort:
            order = np.argsort(words, kind="stable")
        else:
            order = np.arange(len(words))
        self.words = words[order]
        self.ids = order.astype(np.int64)

    @property
    def n(self) -> int:
        return len(self.words)

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            np.int32(self.n).tofile(f)
            np.int32(self.M * self.log_k).tofile(f)
            self.words.tofile(f)

    @classmethod
    def read(cls, path: str, M: int, log_k: int = 8,
             top_n: int = -1) -> "BitVecsStore":
        with open(path, "rb") as f:
            n = int(np.fromfile(f, np.int32, 1)[0])
            _d = int(np.fromfile(f, np.int32, 1)[0])
            if top_n > 0:
                n = min(n, top_n)
            words = np.fromfile(f, np.uint64, n)
        self = cls.__new__(cls)
        self.M = M
        self.log_k = log_k
        self.words = words
        self.ids = np.arange(n, dtype=np.int64)  # identity (file order)
        return self


def dichotomize_codewords(codewords: np.ndarray, seed: int = 0,
                          max_iters: int = 50, device=None) -> np.ndarray:
    """Recursive 2-means reordering of each subspace's codewords
    (``DichotomizeCodewords``, ``pq_tree.cpp:86-128``): within each
    range, centroids are sorted by ``d(c, center0) - d(c, center1)``
    and the halves recurse, so id bit prefixes track spatial halves.
    The 2-means runs on ``device`` (None: the card), every draw from one
    ``torch.Generator`` seeded by ``seed`` (the JAX function splits a
    key instead, so the two packages draw differently).

    Returns the re-ordered codewords [M, K, Ds] (codes must be
    re-encoded against them).
    """
    from ..ops.kmeans import kmeans

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cw = np.array(codewords, np.float32, copy=True)
    M, K, Ds = cw.shape

    def rec(sub: np.ndarray, lo: int, hi: int):
        if hi - lo < 4:
            return
        seg = sub[lo:hi]
        centers, _, _ = kmeans(gen, torch.from_numpy(seg.copy()).to(dev), 2,
                               max_iters=max_iters, n_init=3)
        centers = centers.cpu().numpy()
        d0 = np.sum((seg - centers[0]) ** 2, axis=1)
        d1 = np.sum((seg - centers[1]) ** 2, axis=1)
        order = np.argsort(d0 - d1, kind="stable")
        sub[lo:hi] = seg[order]
        mid = (lo + hi) // 2
        rec(sub, lo, mid)
        rec(sub, mid, hi)

    for m in range(M):
        rec(cw[m], 0, K)
    return cw


def _bound_pyramids(table: np.ndarray, log_k: int):
    """Per-subspace hierarchical min/max over centroid-id ranges
    (``m_sub_bounds``, ``pq_tree.cpp:572-617``): level L has 2^L
    ranges of K/2^L consecutive ids each."""
    M, K = table.shape
    lowers = {log_k: table.copy()}
    uppers = {log_k: table.copy()}
    lo = table
    up = table
    for level in range(log_k - 1, -1, -1):
        lo = lo.reshape(M, 1 << level, 2).min(axis=2)
        up = up.reshape(M, 1 << level, 2).max(axis=2)
        lowers[level] = lo
        uppers[level] = up
    return lowers, uppers


def prefix_tree_query(store: BitVecsStore, codewords: np.ndarray,
                      query: np.ndarray,
                      codes_db: Optional[np.ndarray] = None
                      ) -> Tuple[int, float, dict]:
    """Top-1 branch-and-bound query over the sorted bit-prefix store.

    Returns (database id, ADC distance, stats).  Matches the plain ADC
    scan's top-1 (ties may differ), pruning whole prefix subtrees whose
    lower bound exceeds the running best (``BuildTree``/``ScanLeaves``
    semantics, level-synchronous instead of recursive).
    """
    codewords = np.asarray(codewords, np.float32)
    M, K, Ds = codewords.shape
    log_k = store.log_k
    q = np.asarray(query, np.float32).reshape(-1)[:M * Ds]
    qs = q.reshape(M, Ds)
    table = (np.sum(qs * qs, axis=1)[:, None]
             - 2.0 * np.einsum("md,mkd->mk", qs, codewords)
             + np.sum(codewords * codewords, axis=2))  # [M, K]
    lowers, uppers = _bound_pyramids(table, log_k)

    if codes_db is None:
        codes_db = deinterleave_codes(store.words, M, log_k)
    else:
        codes_db = np.asarray(codes_db)[store.ids]

    def adc(row: int) -> float:
        return float(table[np.arange(M), codes_db[row].astype(np.int64)]
                     .sum())

    # seed the bound with the prefix-matched row (search_prefix,
    # pq_tree.cpp:703-724 — ADC domain, see module docstring)
    q_code = np.argmin(table, axis=1).astype(np.uint64)
    q_word = interleave_codes(q_code[None, :], log_k)[0]
    pos = int(np.searchsorted(store.words, q_word))
    pos = min(pos, store.n - 1)
    best_id = pos
    best = adc(pos)

    # level-synchronous branch and bound over prefix nodes.  A node at
    # level L is a per-subspace id-range of size K >> L; expanding
    # appends one bit per subspace (2^M children), realized as arrays:
    # nodes [n_nodes, M] of range indices at the current level.
    nodes = np.zeros((1, M), np.int64)   # level 0: the full range
    n_expanded = 0
    for level in range(1, log_k + 1):
        # children: every combination of one extra bit per subspace
        n_nodes = len(nodes)
        reps = 1 << M
        bits = ((np.arange(reps)[:, None]
                 >> np.arange(M - 1, -1, -1)[None, :]) & 1)  # [2^M, M]
        children = (nodes[:, None, :] * 2 + bits[None, :, :]
                    ).reshape(-1, M)
        n_expanded += len(children)
        lo_lvl = lowers[level]
        lb = lo_lvl[np.arange(M)[None, :], children].sum(axis=1)
        # prune vs the current best with the reference's EPS slack
        keep = lb - best < best * EPS
        children = children[keep]
        if len(children) == 0:
            break
        # occupancy: does any database word carry this prefix?
        shift = np.uint64((log_k - level) * M)
        # prefix word of a child = interleave of its range indices at
        # significance levels log_k-1..log_k-level
        words = np.zeros(len(children), np.uint64)
        c = children.astype(np.uint64)
        for i in range(M):
            for j in range(level):
                bit = (c[:, i] >> np.uint64(j)) & np.uint64(1)
                words |= bit << np.uint64(
                    (M - 1 - i) + (j + log_k - level) * M)
        starts = np.searchsorted(store.words, words)
        end_keys = words + (np.uint64(1) << shift)
        ends = np.searchsorted(store.words, end_keys)
        # the all-ones prefix wraps end_keys to 0 (64-bit overflow for
        # M*log_k == 64); its range extends to the end of the store
        ends = np.where(end_keys == 0, store.n, ends)
        occupied = ends > starts
        children = children[occupied]
        words = words[occupied]
        starts = starts[occupied]
        ends = ends[occupied]
        if len(children) == 0:
            break
        if level == log_k:
            # leaves: exact ADC over the covered rows (each leaf is a
            # single full code; all rows in [start, end) share it)
            for s, e in zip(starts, ends):
                d = adc(int(s))
                if d < best:
                    best = d
                    best_id = int(s)
            break
        nodes = children
    stats = {"nodes_expanded": int(n_expanded)}
    return int(store.ids[best_id]), best, stats
