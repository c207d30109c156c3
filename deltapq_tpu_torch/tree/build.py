"""Approximate DeltaTree edge finding (methods 1, 2 and 3).

A NumPy copy of ``deltapq_tpu/tree/build.py``: method 1 (height-aware
star, the reference default), 2 (WOH) and 3 (table-aware minimum-weight
reattachment, ``_ta_reattach``); the port cannot import the JAX package.
The tests hold the edges, root and heights equal to the original's.

- rounds diff = 0..diff_argument over a shrinking active set;
- per round, every C(M, M-diff) subset of kept subspaces hashes the
  active codes (kept sub-codes packed into 64/128-bit keys), sorts, and
  groups equal keys into cliques;
- each clique becomes a star: the member with maximum height is the
  parent (method 1; method 2 "WOH" takes the first member), edges
  parent->child are emitted, children leave the active set;
- a parent whose height reaches MAX_HEIGHT-2 (MAX_HEIGHT = M*h) is
  benched into the finalists;
- after all rounds, finalists are chained in a star under finalists[0],
  which becomes the global root.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .. import tracing


def nchoosek(n: int, k: int) -> List[Tuple[int, ...]]:
    """Combination enumeration in the reference's order
    (``create_tree.h:75-90``, prev_permutation == lexicographic)."""
    return list(itertools.combinations(range(n), k))


def round_combos(M: int, diff: int, rng: np.random.Generator,
                 sample_rate: Optional[float], max_combos_per_round: int
                 ) -> List[Tuple[int, ...]]:
    """The kept-subspace combinations that round ``diff`` sorts: all
    C(M, M-diff) of them, or at M > 8 a sample drawn from ``rng`` (see
    ``find_edges_by_diff``)."""
    combos = nchoosek(M, M - diff)
    if M > 8 and len(combos) > 1:
        if sample_rate is not None:
            keep = max(1, int(round(len(combos) * sample_rate)))
        else:
            keep = max_combos_per_round
        if keep < len(combos):
            idx = rng.permutation(len(combos))[:keep]
            combos = [combos[i] for i in sorted(idx)]
    return combos


def pack_keys(codes: np.ndarray, kept: Tuple[int, ...], log_k: int
              ) -> np.ndarray:
    """Pack the kept sub-codes of each row into sortable keys.

    Returns [n] uint64 when kept_dims*log_k <= 64, else [n, 2] uint64
    (hi, lo) for lexicographic grouping — the reference uses uint128
    (``deltapq_create_approx_tree.h:495-514``); only key *equality*
    matters, so we pack kept dims contiguously.
    """
    n = codes.shape[0]
    total_bits = len(kept) * log_k
    if total_bits <= 64:
        key = np.zeros(n, np.uint64)
        for j, m in enumerate(kept):
            key |= codes[:, m].astype(np.uint64) << np.uint64(log_k * j)
        return key
    if total_bits > 128:
        raise NotImplementedError(
            f"keys of {total_bits} bits (>128) not supported; "
            f"M*log2(K) must be <= 128 as in the reference")
    lo = np.zeros(n, np.uint64)
    hi = np.zeros(n, np.uint64)
    per_word = 64 // log_k
    for j, m in enumerate(kept):
        c = codes[:, m].astype(np.uint64)
        if j < per_word:
            lo |= c << np.uint64(log_k * j)
        else:
            hi |= c << np.uint64(log_k * (j - per_word))
    return np.stack([hi, lo], axis=1)


def _group_starts(sorted_keys: np.ndarray) -> np.ndarray:
    """Start indices of equal-key runs in a sorted key array."""
    if sorted_keys.ndim == 1:
        neq = sorted_keys[1:] != sorted_keys[:-1]
    else:
        neq = np.any(sorted_keys[1:] != sorted_keys[:-1], axis=1)
    return np.flatnonzero(np.concatenate([[True], neq]))


@dataclass
class EdgeFindResult:
    edges: np.ndarray          # [E, 2] uint32 (parent_code_id, child_code_id)
    root_id: int
    heights: np.ndarray        # final heights per code id
    n_diffs: int               # total subspace diffs over all edges
    finalists: np.ndarray      # benched code ids (finalists[0] == root)
    rounds_log: list = field(default_factory=list)


def _ta_reattach(codes, tables, sorted_ids, starts, sizes, multi,
                 parent_ids, grp_of, child_mask, par_of_child,
                 ta_hubs: int):
    """Minimum-weight reattachment of clique children (method 3).

    Candidate hubs per clique = the height parent (slot 0) + the first
    ``ta_hubs - 1`` members in sort order.  Every child picks the hub
    minimizing (diff count, table distance); children that are
    themselves hubs keep the height parent so hub chains stay acyclic
    (hub -> parent, child -> any hub).
    """
    P = ta_hubs
    starts_m = starts[multi]
    sizes_m = sizes[multi]
    G = len(starts_m)
    hub_pos = starts_m[:, None] + np.arange(P)[None, :]
    hub_pos = np.minimum(hub_pos, (starts_m + sizes_m - 1)[:, None])
    hub_ids = sorted_ids[hub_pos].astype(np.int64)         # [G, P]
    hub_ids[:, 0] = parent_ids

    # group index (within multi) of each child
    multi_rank = np.cumsum(multi) - 1
    gi = multi_rank[grp_of[child_mask]]                     # [C]
    child_ids = sorted_ids[child_mask].astype(np.int64)     # [C]
    cand = hub_ids[gi]                                      # [C, P]

    cc = codes[child_ids].astype(np.int64)                  # [C, M]
    hc = codes[cand.reshape(-1)].astype(np.int64).reshape(
        cand.shape + (codes.shape[1],))                     # [C, P, M]
    neq = cc[:, None, :] != hc                              # [C, P, M]
    ndiff = neq.sum(axis=2).astype(np.float64)              # [C, P]
    if tables is not None:
        # pure minimum-weight objective (the reference TA's,
        # find_edge.cpp:165-215); diff count breaks exact ties
        M = codes.shape[1]
        dist = np.zeros(cand.shape, np.float64)
        for m in range(M):
            dist += tables[m][cc[:, m][:, None], hc[:, :, m]]
        key = dist + ndiff * 1e-9
    else:
        key = ndiff  # no tables: minimize the diff count
    key = np.where(cand == child_ids[:, None], np.inf, key)
    # hubs themselves must keep the height parent (acyclicity)
    is_hub_child = (cand[:, 1:] == child_ids[:, None]).any(axis=1)
    best = np.argmin(key, axis=1)
    best = np.where(is_hub_child, 0, best)
    return cand[np.arange(len(best)), best].astype(np.uint32)


def find_edges_by_diff(codes: np.ndarray, K: int,
                       diff_argument: Optional[int] = None,
                       max_height_folds: int = 1, method: int = 1,
                       tables: Optional[np.ndarray] = None,
                       ta_hubs: int = 4,
                       sample_rate: Optional[float] = None,
                       max_combos_per_round: int = 64,
                       seed: int = 12345,
                       ) -> EdgeFindResult:
    """Build the approximate minimum-spanning star forest.

    codes: [N, M] uint8/uint16.  Returns edges forming a tree rooted at
    ``root_id`` (N-1 edges when N >= 1).

    method: 1 = height-aware star (reference default,
    ``deltapq_create_approx_tree.h:445-627``); 2 = WOH (``:629-792``);
    3 = TA-style minimum-weight attachment (the quality upgrade kept
    from the reference's dead ``parallel_dist_diff_find_TA``,
    ``find_edge.cpp:48-274``): each clique member attaches to the
    candidate hub (the height parent + the clique's first ``ta_hubs-1``
    members) minimizing table distance (diff count without tables)
    instead of an arbitrary equal-hash parent — a lower-weight tree
    with tighter max_dist bounds and better DFS locality.  Pass
    ``tables`` ([M, K, K] inter-centroid distances); hub chains can
    exceed the height accounting by one level per round (worst case M
    extra levels, repaired at serialization if depth > 15).

    Combination subsampling (M > 8): enumerating every C(M, M-diff)
    kept-subset is impractical at M=16 (65536 sort rounds total), so
    the rounds subsample combinations like the reference
    (``find_edge.cpp:1199-1202``: shuffle then resize to
    ``round(size * sample_rate)``).  ``sample_rate`` gives the
    reference's global rate; the default (None) caps each round at
    ``max_combos_per_round`` random combinations instead — a bounded
    build regardless of M.  Sampling keeps most of the compression: a
    pair differing in d subspaces is matched by any sampled kept-set
    avoiding its d diff positions (e.g. 76% of combos at M=16, d=2),
    so low-diff structure — where the bytes are — survives.  M <= 8
    always enumerates fully (reference behavior).
    """
    if method not in (1, 2, 3):
        raise ValueError(f"unknown edge-finding method {method}")
    codes = np.asarray(codes)
    n, M = codes.shape
    if diff_argument is None:
        diff_argument = M  # forced at deltapq_approx_tree_main.cpp:126
    log_k = max(1, int(round(np.log2(K))))
    max_height = M * max_height_folds

    heights = np.zeros(n, np.int32)
    active = np.arange(n, dtype=np.uint32)       # the DummyNodes set
    finalists: List[int] = []
    edge_parents: List[np.ndarray] = []
    edge_children: List[np.ndarray] = []
    root_id = 0 if n else -1
    rounds_log = []
    n_combos = 0                                 # combinations drawn

    rng = np.random.default_rng(seed)
    for diff in range(diff_argument + 1):
        if len(active) <= 1:
            break
        merged = np.zeros(len(active), bool)   # per-position in `active`
        combos = round_combos(M, diff, rng, sample_rate,
                              max_combos_per_round)
        n_combos += len(combos)
        for kept in combos:
            act_pos = np.flatnonzero(~merged)
            if len(act_pos) <= 1:
                continue
            ids = active[act_pos]
            keys = pack_keys(codes[ids], kept, log_k)
            if keys.ndim == 1:
                # np.argsort(kind="stable") on ints is LSD radix
                # already — measured at parity with a native radix
                order = np.argsort(keys, kind="stable")
            else:
                order = np.lexsort((keys[:, 1], keys[:, 0]))
            sk = keys[order]
            starts = _group_starts(sk)
            sizes = np.diff(np.concatenate([starts, [len(sk)]]))
            multi = sizes >= 2
            if not multi.any():
                continue
            sorted_ids = ids[order]
            h = heights[sorted_ids].astype(np.int64)
            pos = np.arange(len(sorted_ids), dtype=np.int64)

            if method in (1, 3):
                # parent = first member with max height
                gmax = np.maximum.reduceat(h, starts)
                cand = np.where(h == gmax[np.repeat(
                    np.arange(len(starts)), sizes)], pos, len(sk))
                first_max = np.minimum.reduceat(cand, starts)
                parent_pos = first_max[multi]
                gmax_m = gmax[multi]
                # second-highest among non-parent members
                h2 = h.copy()
                h2[parent_pos] = -1
                second = np.maximum.reduceat(h2, starts)[multi]
                parent_ids = sorted_ids[parent_pos]
                bump = second == gmax_m
                heights[parent_ids[bump]] += 1
                new_height = gmax_m + 1
                # method 3's hub chains can add one extra level per
                # round beyond this accounting; the worst-case overrun
                # is M levels, caught by serialize_dtc's auto-repair
            else:  # method 2, WOH: first member is parent
                parent_pos = starts[multi]
                parent_ids = sorted_ids[parent_pos]
                # parent height = max(child height + 1, old)
                h2 = h.copy()
                h2[parent_pos] = -1
                cmax = np.maximum.reduceat(h2, starts)[multi]
                heights[parent_ids] = np.maximum(
                    heights[parent_ids], (cmax + 1).astype(np.int32))
                new_height = heights[parent_ids].astype(np.int64)

            # children: all members except the parent
            grp_of = np.repeat(np.arange(len(starts)), sizes)
            in_multi = multi[grp_of]
            is_parent = np.zeros(len(sk), bool)
            is_parent[parent_pos] = True
            child_mask = in_multi & ~is_parent
            child_ids = sorted_ids[child_mask]
            # map each child to its group's parent id
            grp_parent = np.full(len(starts), -1, np.int64)
            grp_parent[multi] = parent_ids
            par_of_child = grp_parent[grp_of[child_mask]].astype(np.uint32)
            if method == 3 and len(child_ids):
                par_of_child = _ta_reattach(
                    codes, tables, sorted_ids, starts, sizes, multi,
                    parent_ids, grp_of, child_mask, par_of_child,
                    ta_hubs)
            edge_parents.append(par_of_child)
            edge_children.append(child_ids.astype(np.uint32))

            # mark merged: children always; parents when benched
            bench = new_height >= max_height - 2
            bench_ids = parent_ids[bench]
            finalists.extend(int(x) for x in bench_ids)
            pos_in_active = act_pos[order]  # position in `active` array
            merged[pos_in_active[child_mask]] = True
            merged[pos_in_active[parent_pos[bench]]] = True
            if len(parent_ids):
                root_id = int(parent_ids[-1])
        # next round's active set
        active = active[~merged]
        rounds_log.append({"diff": diff, "active_after": len(active)})
        if len(active) <= 1:
            break
    tracing.count("edge_combos", n_combos)

    if len(active) > 0:
        finalists.append(int(active[0]))
        # reference drops any active nodes beyond [0] (only one remains
        # in practice because the diff=M round has a single all-in clique)
    if finalists:
        root_id = finalists[0]
        if len(finalists) > 1:
            fin = np.asarray(finalists, np.uint32)
            edge_parents.append(np.full(len(fin) - 1, fin[0], np.uint32))
            edge_children.append(fin[1:])

    if edge_parents:
        edges = np.stack([np.concatenate(edge_parents),
                          np.concatenate(edge_children)], axis=1)
    else:
        edges = np.empty((0, 2), np.uint32)

    # count diffs (check_num_diffs, deltapq_create_approx_tree.h:196-238)
    if len(edges):
        n_diffs = int(np.sum(codes[edges[:, 0]] != codes[edges[:, 1]]))
    else:
        n_diffs = 0
    return EdgeFindResult(edges=edges, root_id=root_id, heights=heights,
                          n_diffs=n_diffs,
                          finalists=np.asarray(finalists, np.uint32),
                          rounds_log=rounds_log)
