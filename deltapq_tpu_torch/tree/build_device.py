"""The approximate DeltaTree edge search (methods 1 and 2) on a device.

``find_edges_by_diff_device`` takes ``find_edges_by_diff``'s arguments
and returns its ``EdgeFindResult`` bit for bit: the same edges in the
same order, root, heights, diff count, finalists and rounds log.  Every
step of a combination is a sort, a gather or a scatter over the round's
active rows, so the card runs it; the host only draws the combinations
(the same ``np.random.default_rng(seed)`` sequence) and reads the active
count once a round.

How it keeps the NumPy function's order without host reads inside a
round:

- keys are the same packed sub-codes as ``pack_keys``, as int64 with the
  sign bit flipped, so signed order is NumPy's unsigned order; a 128-bit
  key sorts stably by its low word, then by its high word
  (``np.lexsort((lo, hi))``);
- every row of the round is sorted, merged ones too.  A stable sort
  keeps the unmerged rows in the order NumPy sorts them alone; merged
  rows stay in their runs of equal keys but take no part in a group
  (height -1, never a parent or child);
- group ids are the cumulative sum of the key-change mask; each group's
  height maximum, first maximum and second maximum are scatter
  reductions over them, as the ``reduceat`` calls compute them;
- a row is a child at most once and a parent is benched at most once in
  the whole search, so each code id keeps its parent and a sort key
  (combination number, sorted position): sorting the children and the
  finalists by those keys at the end gives NumPy's edge and finalist
  order.  The root is the first finalist, as in NumPy, whenever N >= 1.

Method 3 (``_ta_reattach``) runs on the host only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device, tracing
from .build import EdgeFindResult, round_combos

_SIGN = -(1 << 63)          # xor with it maps unsigned order onto signed


def _pack(cols, kept, log_k):
    """``pack_keys`` on the device: cols [M, A] int64 -> one sign-flipped
    key [A], or (hi, lo) for keys of more than 64 bits.  Shifts drop the
    bits beyond 64 as NumPy's uint64 shifts do."""
    A = cols.shape[1]
    total_bits = len(kept) * log_k
    if total_bits > 128:
        raise NotImplementedError(
            f"keys of {total_bits} bits (>128) not supported; "
            f"M*log2(K) must be <= 128 as in the reference")
    per_word = 64 // log_k if total_bits > 64 else len(kept)
    lo = torch.zeros(A, dtype=torch.int64, device=cols.device)
    hi = torch.zeros_like(lo) if total_bits > 64 else None
    for j, m in enumerate(kept):
        word, shift = (lo, j) if j < per_word else (hi, j - per_word)
        word.bitwise_or_(cols[m] << (log_k * shift))
    for word in (hi, lo):
        if word is not None:
            word.bitwise_xor_(_SIGN)
    return hi, lo


def find_edges_by_diff_device(codes: np.ndarray, K: int,
                              diff_argument: Optional[int] = None,
                              max_height_folds: int = 1, method: int = 1,
                              tables: Optional[np.ndarray] = None,
                              ta_hubs: int = 4,
                              sample_rate: Optional[float] = None,
                              max_combos_per_round: int = 64,
                              seed: int = 12345, device=None
                              ) -> EdgeFindResult:
    """``find_edges_by_diff`` (methods 1 and 2) on ``device`` (None: the
    card).  ``tables`` and ``ta_hubs`` serve method 3 only, which this
    function refuses.  Every tensor it makes is released on return."""
    if method not in (1, 2, 3):
        raise ValueError(f"unknown edge-finding method {method}")
    if method == 3:
        raise NotImplementedError(
            "method 3 (minimum-weight reattachment) runs on the host: "
            "use tree.build.find_edges_by_diff")
    dev = resolve_device(device)
    codes = np.asarray(codes)
    n, M = codes.shape
    if diff_argument is None:
        diff_argument = M
    log_k = max(1, int(round(np.log2(K))))
    max_height = M * max_height_folds

    host = codes if codes.dtype == np.uint8 else codes.astype(np.int64)
    codes_d = torch.from_numpy(np.ascontiguousarray(host)).to(dev)
    i64 = dict(dtype=torch.int64, device=dev)
    heights = torch.zeros(n, dtype=torch.int32, device=dev)
    # per code id, slot n a sink for rows that write nothing
    parent_of = torch.full((n + 1,), -1, **i64)
    edge_key = torch.full((n + 1,), -1, **i64)   # (combo, position)
    fin_key = torch.full((n + 1,), -1, **i64)
    active = torch.arange(n, **i64)
    rounds_log = []
    seq = 0                                      # combinations so far

    rng = np.random.default_rng(seed)
    for diff in range(diff_argument + 1):
        A = len(active)
        if A <= 1:
            break
        combos = round_combos(M, diff, rng, sample_rate,
                              max_combos_per_round)
        cols = codes_d[active].T.contiguous().to(torch.int64)  # [M, A]
        merged = torch.zeros(A, dtype=torch.bool, device=dev)
        pos = torch.arange(A, **i64)
        for kept in combos:
            hi, lo = _pack(cols, kept, log_k)
            sk, order = torch.sort(lo, stable=True)
            change = sk[1:] != sk[:-1]
            if hi is not None:
                sh, o2 = torch.sort(hi[order], stable=True)
                order = order[o2]
                sk = sk[o2]
                change = (sk[1:] != sk[:-1]) | (sh[1:] != sh[:-1])
            gid = torch.zeros(A, **i64)
            gid[1:] = torch.cumsum(change, 0)
            ids = active[order]
            valid = ~merged[order]
            h = heights[ids]
            hv = torch.where(valid, h, -1)
            size = torch.zeros(A, dtype=torch.int32, device=dev
                               ).index_add_(0, gid, valid.int())
            multi = (size >= 2)[gid]
            if method == 1:        # parent: first member of max height
                gmax = torch.full((A,), -1, dtype=torch.int32, device=dev
                                  ).scatter_reduce_(0, gid, hv, "amax")[gid]
                cand = torch.where(valid & (hv == gmax), pos, A)
            else:                  # WOH: the first member is the parent
                cand = torch.where(valid, pos, A)
            ppos = torch.full((A,), A, **i64).scatter_reduce_(
                0, gid, cand, "amin")[gid]
            is_par = pos == ppos
            second = torch.full((A,), -1, dtype=torch.int32, device=dev
                                ).scatter_reduce_(
                0, gid, torch.where(is_par, -1, hv), "amax")[gid]
            par = is_par & multi
            if method == 1:
                heights.index_add_(0, ids, (par & (second == gmax)).int())
                new_height = gmax + 1
            else:
                new_height = torch.maximum(h, second + 1)
                heights.index_put_((ids,), torch.where(par, new_height, h))
            bench = par & (new_height >= max_height - 2)
            child = valid & multi & ~is_par
            key = pos + seq * (n + 1)
            sink = torch.where(child, ids, n)
            parent_of.index_put_((sink,), ids[ppos.clamp(max=A - 1)])
            edge_key.index_put_((sink,), key)
            fin_key.index_put_((torch.where(bench, ids, n),), key)
            merged.index_put_((order,), ~valid | child | bench)
            seq += 1
        active = active[~merged]
        rounds_log.append({"diff": diff, "active_after": len(active)})
    tracing.count("edge_combos", seq)

    children = torch.nonzero(parent_of[:n] >= 0).squeeze(1)
    children = children[torch.sort(edge_key[children]).indices]
    fin = torch.nonzero(fin_key[:n] >= 0).squeeze(1)
    fin = torch.cat([fin[torch.sort(fin_key[fin]).indices], active[:1]])
    parents = torch.cat([parent_of[children], fin[:1].expand(
        max(len(fin) - 1, 0))])
    children = torch.cat([children, fin[1:]])
    n_diffs = (codes_d[parents] != codes_d[children]).sum().view(1)
    # one copy back: parents, children, finalists, heights, diff count
    out = torch.cat([parents, children, fin, heights.long(), n_diffs]
                    ).cpu().numpy()
    E, F = len(parents), len(fin)
    edges = np.stack([out[:E], out[E:2 * E]], axis=1).astype(np.uint32)
    finalists = out[2 * E:2 * E + F].astype(np.uint32)
    return EdgeFindResult(
        edges=edges, root_id=int(finalists[0]) if F else -1,
        heights=out[2 * E + F:2 * E + F + n].astype(np.int32),
        n_diffs=int(out[-1]), finalists=finalists, rounds_log=rounds_log)
