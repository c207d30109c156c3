"""DeltaTree construction, DFS layout, re-rooting and the code formats
(NumPy copies of ``deltapq_tpu/tree``)."""

from .build import find_edges_by_diff, nchoosek, pack_keys, EdgeFindResult
from .layout import DeltaTree, build_layout, mkk_tables, ancestor_max_dists
from .serialize import (serialize_dtc, deserialize_dtc, decode_dtc_to_codes,
                        write_dtc, read_dtc_raw, serialize_diff_index,
                        decode_diff_index, write_diff_index)

__all__ = [
    "find_edges_by_diff", "nchoosek", "pack_keys", "EdgeFindResult",
    "DeltaTree", "build_layout", "mkk_tables", "ancestor_max_dists",
    "serialize_dtc", "deserialize_dtc", "decode_dtc_to_codes", "write_dtc",
    "read_dtc_raw", "serialize_diff_index", "decode_diff_index",
    "write_diff_index",
]
