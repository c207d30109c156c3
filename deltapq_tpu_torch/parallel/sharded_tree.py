"""Sharded DeltaTree index: the level-wise compressed-code query over the
port's mesh.

Counterpart of ``deltapq_tpu/parallel/sharded_tree.py``: NumPy host code
(a copy of the JAX package's, held byte-equal by the tests) and the
level-wise query of ``ops/delta.py`` a shard (plain PyTorch, as the JAX
package computes it in XLA).

- the database is split into S contiguous row partitions and one
  DeltaTree is built a partition (independent builds, over a ``spawn``
  process pool with ``workers`` > 1);
- each shard's level-major arrays (``ops/delta.py``) are padded to
  common per-level shapes and stacked on a leading shard axis;
- each shard runs its traversal and keeps a local top-k; the candidates
  merge with ``mesh.gather_topk``.

Padding: level blocks pad to the per-level maximum across shards;
padded slots get parent_local=0 and no diffs, producing distances that
the final database-order gather never reads (db_to_lm only targets real
rows, and rows beyond a shard's n_local are masked).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.adc import adc_table
from ..ops.delta import build_delta_pack, level_dists
from ..ops.fused import _np_f32
from ..ops.topk import smallest_k
from ..tree.build import find_edges_by_diff
from ..tree.layout import DeltaTree, build_layout
from .mesh import Mesh, gather_topk, make_mesh
from .sharded import _codewords_on, _padded_queries


@dataclass
class ShardedDeltaPack:
    """Stacked + padded level-major arrays for S shards."""

    # per level: parent_local [S, nd_max], seg/midx_to/midx_from
    # [S, td_max]
    levels: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]
    root_idx: np.ndarray      # [S, M] flat table indices of root codes
    db_to_lm: np.ndarray      # [S, n_pad] local db id -> level-major pos
    n_local: np.ndarray       # [S] true rows per shard
    row_base: np.ndarray      # [S] global id offset of each partition
    n_pad: int                # padded db rows per shard
    lm_size: int              # 1 + sum of padded level sizes
    M: int
    K: int
    level_skew: float = 1.0   # max/mean padded-level inflation across
                              # shards (memory cost of the [S, max]
                              # padding; ~1 = balanced)


def _build_shard_tree(args):
    part, K, codewords, tree_kwargs = args
    res = find_edges_by_diff(part, K=K, **tree_kwargs)
    return build_layout(part, res.edges, res.root_id, K=K,
                        codewords=codewords)


def build_sharded_trees(codes: np.ndarray, K: int, n_shards: int,
                        codewords: np.ndarray, workers: int = 0,
                        **tree_kwargs
                        ) -> Tuple[List[DeltaTree], np.ndarray]:
    """Split rows into contiguous partitions and build one DeltaTree per
    partition, over a ``spawn`` process pool when ``workers`` > 1 (0 =
    serial; the children import this package and torch but never touch
    a card, so a script calling this needs an ``if __name__ ==
    "__main__":`` guard).

    Returns (trees, true_sizes): a shard with no rows gets a 1-row dummy
    tree whose true size is 0 (its results are masked out).  Every
    shard's per-level arrays pad to the global per-level maximum, so one
    deep or skewed shard inflates all shards' memory by up to
    max / mean level size; the pack records it as ``level_skew``."""
    n = len(codes)
    per = -(-n // n_shards)
    jobs = []
    sizes = np.zeros(n_shards, np.int32)
    for s in range(n_shards):
        part = codes[s * per:(s + 1) * per]
        sizes[s] = len(part)
        if len(part) == 0:
            part = codes[:1]  # degenerate shard: dummy row, size 0
        jobs.append((np.ascontiguousarray(part), K, codewords,
                     tree_kwargs))
    if workers and workers > 1 and n_shards > 1:
        # spawn, not fork: the parent's torch (and CUDA) runtime is
        # multithreaded, and fork risks deadlock in the children
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=mp.get_context("spawn")) as ex:
            trees = list(ex.map(_build_shard_tree, jobs))
    else:
        trees = [_build_shard_tree(j) for j in jobs]
    return trees, sizes


def build_sharded_pack(trees: List[DeltaTree], row_bases: np.ndarray,
                       true_sizes: np.ndarray = None) -> ShardedDeltaPack:
    packs = [build_delta_pack(t) for t in trees]
    S = len(packs)
    M, K = packs[0].M, packs[0].K
    n_pad = max(p.n for p in packs)
    n_levels = max(len(p.levels) for p in packs)

    levels = []
    level_nd = []
    for d in range(n_levels):
        nd_max = max((len(p.levels[d].parent_local) if d < len(p.levels)
                      else 0) for p in packs)
        td_max = max((len(p.levels[d].seg) if d < len(p.levels) else 0)
                     for p in packs)
        nd_max = max(nd_max, 1)
        td_max = max(td_max, 1)
        parent = np.zeros((S, nd_max), np.int32)
        seg = np.full((S, td_max), nd_max - 1, np.int32)
        midx_to = np.zeros((S, td_max), np.int32)
        midx_from = np.zeros((S, td_max), np.int32)
        for s, p in enumerate(packs):
            if d >= len(p.levels):
                continue
            lp = p.levels[d]
            nd, td = len(lp.parent_local), len(lp.seg)
            parent[s, :nd] = lp.parent_local
            seg[s, :td] = lp.seg
            midx_to[s, :td] = lp.dm * K + lp.dto
            midx_from[s, :td] = lp.dm * K + lp.dfrom
        levels.append((parent, seg, midx_to, midx_from))
        level_nd.append(nd_max)

    # padding skew: total padded cells vs total real cells
    real = sum(len(p.levels[d].parent_local)
               for p in packs for d in range(len(p.levels)))
    padded = S * sum(level_nd)
    skew = padded / max(real, 1)

    # per-shard db_to_lm remapped into the PADDED level-major space:
    # shard-local level offsets differ from the padded ones
    lm_size = 1 + sum(level_nd)
    pad_off = np.concatenate([[0], [1], 1 + np.cumsum(level_nd)])[:-1]
    # pad_off[d] = start of level d block (level 0 = root at 0)
    db_to_lm = np.zeros((S, n_pad), np.int32)
    n_local = np.zeros(S, np.int32)
    for s, p in enumerate(packs):
        # p.db_to_lm indexes the shard's own compact level-major space;
        # recompute with padded offsets
        own_nd = [len(lp.parent_local) for lp in p.levels]
        own_off = np.concatenate([[0], [1], 1 + np.cumsum(own_nd)])[:-1]
        lm = p.db_to_lm.astype(np.int64)
        # find each position's level via searchsorted on own offsets
        lev = np.searchsorted(np.concatenate([own_off[1:], [np.iinfo(
            np.int64).max]]), lm, side="right")
        local_in_level = lm - own_off[lev]
        db_to_lm[s, :p.n] = (pad_off[lev] + local_in_level).astype(np.int32)
        n_local[s] = p.n if true_sizes is None else int(true_sizes[s])
    root_idx = np.stack([np.arange(M, dtype=np.int32) * K + p.root_code
                         for p in packs])
    return ShardedDeltaPack(level_skew=float(skew),
                            levels=levels, root_idx=root_idx,
                            db_to_lm=db_to_lm, n_local=n_local,
                            row_base=np.asarray(row_bases, np.int32),
                            n_pad=n_pad, lm_size=lm_size, M=M, K=K)


def make_sharded_compressed_query_fn(mesh: Mesh, pack: ShardedDeltaPack,
                                     top_k: int
                                     ) -> Callable[[torch.Tensor], Tuple]:
    """Returns ``run(table [B, M, K]) -> (dists [B, top_k], global ids
    [B, top_k])`` on ``mesh.devices[0]``; this process's shards of the
    pack are uploaded once, each to its shard's device."""
    S = mesh.size
    if pack.root_idx.shape[0] != S:
        raise ValueError(f"pack has {pack.root_idx.shape[0]} shards, mesh "
                         f"has {S}")
    n_pad = pack.n_pad

    def up(a, g, dev):
        return torch.from_numpy(np.ascontiguousarray(a[g]).astype(
            np.int64)).to(dev)

    shards = []
    for g, dev in zip(mesh.shard_ids(), mesh.devices):
        shards.append(dict(
            dev=dev,
            levels=[tuple(up(a, g, dev) for a in lv) for lv in pack.levels],
            root_idx=up(pack.root_idx, g, dev),
            db_to_lm=up(pack.db_to_lm, g, dev),
            n_local=int(pack.n_local[g]), row_base=int(pack.row_base[g])))

    def run(table):
        B = table.shape[0]
        tables = {d: table.to(d).reshape(B, -1)
                  for d in dict.fromkeys(mesh.devices)}
        ds, ids = [], []
        for sh in shards:
            dev = sh["dev"]
            db_dist = level_dists(tables[dev], sh["root_idx"],
                                  sh["levels"]).index_select(
                1, sh["db_to_lm"])                             # [B, n_pad]
            valid = torch.arange(n_pad, device=dev) < sh["n_local"]
            db_dist = torch.where(valid[None, :], db_dist,
                                  torch.full_like(db_dist, float("inf")))
            # a shard can hold fewer rows than top_k: smallest_k pads
            # with (+inf, -1), which the merge keeps behind real rows
            d, li = smallest_k(db_dist, top_k, "exact")
            ds.append(d)
            ids.append(torch.where(li >= 0, li + sh["row_base"], li))
        return gather_topk(mesh, ds, ids, top_k)

    return run


def sharded_query_compressed(codewords, codes: np.ndarray,
                             queries: np.ndarray, top_k: int = 10,
                             mesh: Optional[Mesh] = None, device=None,
                             **tree_kwargs
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end: build per-shard DeltaTrees (``tree_kwargs`` go to
    ``build_sharded_trees``: ``workers``, ``method``, ...), run the
    sharded compressed query (``mesh`` None: every local device of
    ``device``), return NumPy (dists, global ids)."""
    if mesh is None:
        mesh = make_mesh(device=device)
    S = mesh.size
    cwn = _np_f32(codewords)
    n = len(codes)
    per = -(-n // S)
    row_bases = np.arange(S, dtype=np.int32) * per
    trees, sizes = build_sharded_trees(np.asarray(codes), int(cwn.shape[1]),
                                       S, cwn, **tree_kwargs)
    pack = build_sharded_pack(trees, row_bases, sizes)
    M, K, Ds = cwn.shape
    cw = _codewords_on(cwn, mesh.devices[0])
    table = adc_table(cw, _padded_queries(queries, M * Ds).to(cw.device))
    run = make_sharded_compressed_query_fn(mesh, pack, top_k)
    d, i = run(table)
    return d.cpu().numpy(), i.cpu().numpy()
