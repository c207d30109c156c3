"""Configuration objects for the deltapq-tpu engine.

A copy of ``deltapq_tpu/config.py`` (the port cannot import the JAX
package); the tests hold every file name equal to the original's.

The reference implementation steers everything through mutable globals
(``PQ_M``, ``PQ_K``, ``with_id`` — declared per-binary in
``main.cpp:13-15`` and ``deltapq_approx_tree_main.cpp:8-12`` and shared
via ``extern`` in the headers) plus hand-parsed argv flags
(``main.cpp:183-233``).  Here everything is an explicit, immutable
dataclass that is threaded through the pipeline; artifact file names are
derived from the config so staged results can be cached and cross-checked
against files produced by the reference binaries (same naming scheme,
e.g. ``M8K256codewords.txt``, ``codes.bin.plain.M8K256``,
``M8K256H1_Approx_Edges_N...``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class PQConfig:
    """Product-quantization parameters (reference: globals + Learn args).

    M:  number of subspaces  (reference default 8, ``main.cpp:14``)
    K:  centroids/subspace   (reference default 256, ``main.cpp:13``)
    dim: raw vector dimensionality; padded up to a multiple of M with
         zeros exactly like ``PQ::Learn`` (``pq.cpp:113-124``) and
         ``PQTree::EncodePlain`` (``pq_tree.cpp:194-198``).
    """

    M: int = 8
    K: int = 256
    dim: int = 128

    def __post_init__(self):
        if self.M <= 0 or self.K <= 1:
            raise ValueError(f"invalid PQ config M={self.M} K={self.K}")

    @property
    def padded_dim(self) -> int:
        """dim rounded up to a multiple of M (zero padding)."""
        return ((self.dim + self.M - 1) // self.M) * self.M

    @property
    def Ds(self) -> int:
        """Per-subspace dimensionality."""
        return self.padded_dim // self.M

    @property
    def code_dtype(self):
        """uint8 for K<=256, uint16 above (reference ``pq_tree.cpp:232-236``)."""
        import numpy as np

        return np.uint8 if self.K <= 256 else np.uint16

    @property
    def log2_K(self) -> int:
        """Bits per sub-code used for hash packing (reference LOG_K,
        ``deltapq_create_approx_tree.h:454``)."""
        return max(1, int(round(math.log2(self.K))))

    @property
    def code_bytes_per_vec(self) -> int:
        return self.M * (1 if self.K <= 256 else 2)


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Approximate DeltaTree construction parameters.

    diff:   maximum edge weight rounds 0..diff (reference ``-diff``,
            forced to M at ``deltapq_approx_tree_main.cpp:126``).
    h:      max-height multiplier; MAX_HEIGHT = M*h
            (``deltapq_create_approx_tree.h:1262``).
    method: 1 = star trees with height tracking
            (``partition_linear_opt_approx_with_constraint``),
            2 = WOH, first clique member is parent
            (``..._WOH``, ``deltapq_create_approx_tree.h:629-792``).
    """

    diff: Optional[int] = None  # None -> M
    h: int = 1
    method: int = 1

    def resolved_diff(self, M: int) -> int:
        return self.diff if self.diff is not None else M

    def max_height(self, M: int) -> int:
        return M * self.h


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    """Query-execution parameters."""

    top_k: int = 10
    batch_size: int = 128  # queries per device dispatch
    tile_n: int = 8192  # database rows per scan tile
    accum_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Distributed layout: codes/tree partitions sharded along the
    database axis over a 1-D mesh (no reference counterpart; the
    reference is single-process OpenMP, SURVEY.md §2.8)."""

    axis_name: str = "shard"
    num_shards: Optional[int] = None  # None -> all local devices


# --------------------------------------------------------------------------
# Reference-compatible artifact file names
# --------------------------------------------------------------------------

def codewords_filename(cfg: PQConfig) -> str:
    """``main.cpp:268``: <dataset>/M{M}K{K}codewords.txt"""
    return f"M{cfg.M}K{cfg.K}codewords.txt"


def codes_filename(cfg: PQConfig, n: Optional[int] = None,
                   with_id: bool = False) -> str:
    """``main.cpp:409``: codes.bin.plain.M{M}K{K}N{N}."""
    name = f"codes.bin.plain.M{cfg.M}K{cfg.K}"
    if n is not None:
        name += f"N{n}"
    if with_id:
        name += ".with_id"
    return name


def _method_suffix(method: int) -> str:
    return {1: "", 2: "_WOH", 3: "_clique"}[method]


def edges_filename(cfg: PQConfig, tree: TreeConfig, n: int,
                   with_id: bool = False) -> str:
    """``deltapq_create_approx_tree.h:1215-1229``."""
    name = f"M{cfg.M}K{cfg.K}H{tree.h}_Approx_Edges"
    if with_id:
        name += "_with_id"
    name += _method_suffix(tree.method)
    return name + f"_N{n}"


def tree_nodes_filename(cfg: PQConfig, tree: TreeConfig, n: int,
                        with_id: bool = False) -> str:
    """``deltapq_create_approx_tree.h:1343-1356``."""
    name = f"M{cfg.M}K{cfg.K}_Approx_TreeNodesDFS"
    if with_id:
        name += "_with_id"
    name += _method_suffix(tree.method)
    return name + f"_N{n}"


def compressed_codes_filename(cfg: PQConfig, tree: TreeConfig, n: int,
                              with_id: bool = False) -> str:
    """``deltapq_create_approx_tree.h:1735-1748``."""
    name = f"M{cfg.M}K{cfg.K}_Approx_compressed_codes_opt"
    if with_id:
        name += "_with_id"
    name += _method_suffix(tree.method)
    return name + f"_N{n}"


def diff_index_filename(cfg: PQConfig, n: int) -> str:
    """``deltapq_create_approx_tree.h:1975-1977``."""
    return f"M{cfg.M}K{cfg.K}_diff_index_N{n}"


def groundtruth_filename(n: int, top_k: int) -> str:
    """``main.cpp:600-607``: groundtruth/N{N}Top{K}.txt"""
    return f"N{n}Top{top_k}.txt"
