"""Embedded-id DeltaTree variant (reference ``approx_with_id``).

A NumPy copy of ``deltapq_tpu/tree/with_id.py``; the tests hold the
tree's arrays equal to the original's.

The reference appends the 4 little-endian id bytes to every code and
builds the tree over M+4 "subspaces" (``deltapq_approx_tree_main.cpp:
186-264``: ``M_arg = PQ_M + sizeof(int)``, ``diff_argument`` likewise),
so the compressed stream itself carries vector ids (for row-store
deployments where DFS position is not a usable result id).  Note the
reference's one-byte bitmap cannot actually address subspaces m >= 8,
so its with_id byte format is broken for M=8+4; here the embedded-id
tree is built and queried via the SoA/level-wise path (no DTC byte
stream), which has no such limit.

Query-time: the ADC table gets 4 zero columns for the id subspaces, so
distances are identical to the plain M-subspace scan; result ids are
read back from the decoded id bytes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .build import find_edges_by_diff
from .layout import DeltaTree, build_layout


def append_id_bytes(codes: np.ndarray,
                    ids: np.ndarray = None) -> np.ndarray:
    """[N, M] uint8 -> [N, M+4] uint8 with little-endian id bytes."""
    n, M = codes.shape
    if ids is None:
        ids = np.arange(n, dtype="<u4")
    idb = np.ascontiguousarray(ids, "<u4").view(np.uint8).reshape(n, 4)
    return np.concatenate([codes, idb], axis=1)


def split_id_bytes(codes_ext: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of append_id_bytes."""
    M = codes_ext.shape[1] - 4
    codes = codes_ext[:, :M].copy()
    ids = np.ascontiguousarray(codes_ext[:, M:]).view("<u4").ravel().copy()
    return codes, ids


def build_tree_with_id(codes: np.ndarray, K: int, codewords: np.ndarray,
                       ids: np.ndarray = None, **tree_kwargs) -> DeltaTree:
    """Build an embedded-id DeltaTree over the extended M+4 codes.

    The per-subspace distance tables for the 4 id subspaces are zero, so
    edge-weight ordering (max_dist2p) and query distances see only the
    real M subspaces.
    """
    codes = np.asarray(codes)
    if K > 256 or codes.dtype != np.uint8:
        # uint16 codes cannot be packed into the 8-bit id-extended key
        # slots (adjacent subspaces would overlap, producing corrupt
        # hash cliques); the reference likewise only supports with_id
        # for 1-byte codes (deltapq_approx_tree_main.cpp:186-264)
        raise NotImplementedError("approx_with_id requires K <= 256 "
                                  "(uint8 codes)")
    ext = append_id_bytes(codes, ids)
    M = codes.shape[1]
    # pack keys with 8 bits/column regardless of K: id bytes span 0..255
    res = find_edges_by_diff(ext, K=256, **tree_kwargs)
    # extend the K x K tables with zero tables for the id subspaces
    from .layout import mkk_tables

    tables = mkk_tables(codewords)
    zeros = np.zeros((4, 256, 256), np.float32)
    Kt = tables.shape[1]
    if Kt < 256:
        tables = np.pad(tables, ((0, 0), (0, 256 - Kt), (0, 256 - Kt)))
    tables_ext = np.concatenate([tables, zeros], axis=0)
    tree = build_layout(ext, res.edges, res.root_id, K=256,
                        tables=tables_ext)
    return tree


def extend_table_for_id(table: np.ndarray) -> np.ndarray:
    """ADC table [B, M, K] -> [B, M+4, 256] with zero id columns."""
    B, M, K = table.shape
    out = np.zeros((B, M + 4, 256), np.float32)
    out[:, :M, :K] = table
    return out
