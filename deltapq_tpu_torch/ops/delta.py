"""Compressed-code (DeltaTree) query, level by level, in plain PyTorch.

Counterpart of ``deltapq_tpu/ops/delta.py``, which computes it in XLA
(no Pallas kernel, so no hand-written kernel here either).  The
reference scans the DTC stream sequentially per query with a stack of
(code, distance) per tree depth, updating
``dist = parent_dist - T[m][from] + T[m][to]`` per diff
(``deltapq_create_approx_tree.h:2805-2984``).  Here the stack recurrence
runs level by level: all nodes at depth d depend only on depth d-1, so
each level is one gather of the parents' distances plus a segment sum
of the level's diff terms (``index_select`` and ``index_add_`` where the
JAX package has ``jnp.take`` and ``segment_sum``), in the JAX order:
the root's table sum, then per level parent distance + segment sum of
(T_to - T_from).

Nodes are stored level-major (sorted by depth, then DFS position), so a
level's output is one contiguous block and the blocks concatenate; one
final gather permutes level-major distances back to database order.
The whole [B, N] f32 distance matrix is held at once, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..tree.layout import DeltaTree, _ragged_indices


@dataclass
class LevelPack:
    """Per-depth flat arrays for one level of the DeltaTree
    (level-major local indices)."""

    parent_local: np.ndarray  # i32[n_d] index into level d-1's block
    seg: np.ndarray           # i32[t_d] index into 0..n_d-1 per diff
    dm: np.ndarray            # i32[t_d] subspace of each diff
    dfrom: np.ndarray         # i32[t_d] parent's centroid id
    dto: np.ndarray           # i32[t_d] node's centroid id


@dataclass
class DeltaPack:
    """Level-major layout of a DeltaTree (host arrays)."""

    levels: List[LevelPack]
    root_code: np.ndarray     # [M] int32
    db_to_lm: np.ndarray      # [N] int32: database id -> level-major pos
    n: int
    M: int
    K: int


def build_delta_pack(tree: DeltaTree) -> DeltaPack:
    """Host-side preparation (a NumPy copy of the JAX package's): sort
    nodes level-major, flatten each level's diffs, and resolve each
    diff's ``from`` (= the parent's centroid in that subspace, which the
    DTC stream stores implicitly via the decode stack)."""
    decoded_db = tree.decode_codes()
    codes_dfs = decoded_db[tree.vec_id.astype(np.int64)].astype(np.int32)

    n = tree.n
    maxd = int(tree.depth.max()) if n else 0
    # level-major order: stable sort by depth keeps DFS order within level
    order = np.argsort(tree.depth, kind="stable").astype(np.int64)
    lm_pos = np.empty(n, np.int64)
    lm_pos[order] = np.arange(n)
    level_off = np.searchsorted(tree.depth[order], np.arange(maxd + 2))

    levels: List[LevelPack] = []
    for d in range(1, maxd + 1):
        sel = order[level_off[d]:level_off[d + 1]]  # DFS positions, lvl d
        cnt = tree.diff_num[sel].astype(np.int64)
        flat = _ragged_indices(tree.diff_off[sel], cnt)
        seg = np.repeat(np.arange(len(sel)), cnt).astype(np.int32)
        dm = tree.diff_m[flat].astype(np.int32)
        dto = tree.diff_to[flat].astype(np.int32)
        par = tree.parent_pos[sel].astype(np.int64)
        dfrom = codes_dfs[np.repeat(par, cnt), dm]
        parent_local = (lm_pos[par] - level_off[d - 1]).astype(np.int32)
        levels.append(LevelPack(
            parent_local=parent_local, seg=seg, dm=dm,
            dfrom=dfrom.astype(np.int32), dto=dto))

    # database id -> level-major position
    db_to_lm = np.empty(n, np.int64)
    db_to_lm[tree.vec_id.astype(np.int64)] = lm_pos
    return DeltaPack(levels=levels,
                     root_code=codes_dfs[0].astype(np.int32),
                     db_to_lm=db_to_lm.astype(np.int32),
                     n=n, M=tree.M, K=tree.K)


def _flat(pack: DeltaPack, fn, device) -> torch.Tensor:
    """One int64 index buffer on ``device``: ``fn(level)`` of every level
    concatenated."""
    parts = [fn(lp) for lp in pack.levels] or [np.zeros(0, np.int32)]
    return torch.from_numpy(np.concatenate(parts).astype(np.int64)).to(
        device)


def level_dists(tf: torch.Tensor, root_idx: torch.Tensor, levels
                ) -> torch.Tensor:
    """Distances [B, nodes] in level-major order from the flat table
    ``tf`` [B, M*K]: the root's table sum, then each level's parents'
    distances plus its summed diff terms.  ``levels`` yields a level's
    (parent_local, seg, midx_to, midx_from) index tensors."""
    B = tf.shape[0]
    prev = torch.sum(tf.index_select(1, root_idx), dim=1)[:, None]
    blocks = [prev]
    for parent_local, seg, midx_to, midx_from in levels:
        terms = (tf.index_select(1, midx_to)
                 - tf.index_select(1, midx_from))
        delta = torch.zeros((B, parent_local.shape[0]), dtype=tf.dtype,
                            device=tf.device)
        delta.index_add_(1, seg, terms)
        prev = prev.index_select(1, parent_local) + delta
        blocks.append(prev)
    return torch.cat(blocks, dim=1)


def make_compressed_query_fn(pack: DeltaPack, device=None
                             ) -> Callable[[torch.Tensor], torch.Tensor]:
    """(table [B, M, K] f32 on ``device``) -> dists [B, N] in database
    order, running the level-wise traversal.  The levels' index arrays
    are uploaded once, as four flat buffers sliced per level."""
    device = resolve_device(device)
    level_sizes = [len(lp.parent_local) for lp in pack.levels]
    diff_sizes = [len(lp.seg) for lp in pack.levels]
    node_off = np.concatenate([[0], np.cumsum(level_sizes)]).astype(int)
    diff_off = np.concatenate([[0], np.cumsum(diff_sizes)]).astype(int)
    parent_all = _flat(pack, lambda lp: lp.parent_local, device)
    seg_all = _flat(pack, lambda lp: lp.seg, device)
    midx_to_all = _flat(pack, lambda lp: lp.dm * pack.K + lp.dto, device)
    midx_from_all = _flat(pack, lambda lp: lp.dm * pack.K + lp.dfrom,
                          device)
    root_idx = torch.from_numpy(
        np.arange(pack.M, dtype=np.int64) * pack.K
        + pack.root_code).to(device)
    db_to_lm = torch.from_numpy(pack.db_to_lm.astype(np.int64)).to(device)
    levels = [(parent_all[node_off[d]:node_off[d + 1]],
               seg_all[diff_off[d]:diff_off[d + 1]],
               midx_to_all[diff_off[d]:diff_off[d + 1]],
               midx_from_all[diff_off[d]:diff_off[d + 1]])
              for d in range(len(level_sizes))]

    def run(table: torch.Tensor) -> torch.Tensor:
        tf = table.reshape(table.shape[0], -1)
        return level_dists(tf, root_idx, levels).index_select(1, db_to_lm)

    return run


def query_compressed(pack: DeltaPack, codewords, queries: np.ndarray,
                     top_k: int = 10, device=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end compressed query on ``device``: ADC tables + level-wise
    traversal + exact top-k.  Returns NumPy (dists [B, top_k], ids
    [B, top_k]) in database-id space, ascending distance."""
    from .adc import adc_table
    from .topk import smallest_k

    device = resolve_device(device)
    cw = codewords if isinstance(codewords, torch.Tensor) else \
        torch.from_numpy(np.asarray(codewords, np.float32))
    cw = cw.to(device=device, dtype=torch.float32)
    M, K, Ds = cw.shape
    q = np.asarray(queries, np.float32)
    if q.shape[1] < M * Ds:
        q = np.pad(q, ((0, 0), (0, M * Ds - q.shape[1])))
    table = adc_table(cw, torch.from_numpy(q).to(device))
    dists = make_compressed_query_fn(pack, device)(table)  # [B, N] db order
    d, ids = smallest_k(dists, top_k, "exact")
    return d.cpu().numpy(), ids.cpu().numpy()
