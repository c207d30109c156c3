"""NumPy-typed wrappers over the native library (ctypes).

A copy of ``deltapq_tpu/native/api.py``: each function returns None when
the library is unavailable and raises ``ValueError`` when the C code
reports a malformed input."""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .build import get_lib


def _p(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def dtc_decode_native(stream: np.ndarray, n_codes: int, M: int
                      ) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    stream = np.ascontiguousarray(stream, np.uint8)
    out = np.empty((n_codes, M), np.uint8)
    r = lib.dtc_decode(_p(stream, ctypes.c_uint8), len(stream), n_codes, M,
                       _p(out, ctypes.c_uint8))
    if r < 0:
        raise ValueError("dtc_decode failed")
    return out


def dtc_parse_native(stream: np.ndarray, n_codes: int, M: int
                     ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]]:
    lib = get_lib()
    if lib is None:
        return None
    stream = np.ascontiguousarray(stream, np.uint8)
    depth = np.empty(n_codes, np.uint8)
    bitmap = np.empty(n_codes, np.uint8)
    diff_off = np.empty(n_codes + 1, np.int64)
    diff_to = np.empty(len(stream), np.uint8)  # upper bound
    r = lib.dtc_parse(_p(stream, ctypes.c_uint8), len(stream), n_codes, M,
                      _p(depth, ctypes.c_uint8), _p(bitmap, ctypes.c_uint8),
                      _p(diff_off, ctypes.c_int64),
                      _p(diff_to, ctypes.c_uint8))
    if r < 0:
        raise ValueError("dtc_parse failed")
    return depth, bitmap, diff_to[:r].copy(), diff_off


def dfs_layout_native(n: int, child_sorted: np.ndarray, offsets: np.ndarray,
                      root_id: int
                      ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]]:
    lib = get_lib()
    if lib is None:
        return None
    child_sorted = np.ascontiguousarray(child_sorted, np.uint32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    dfs_vec = np.empty(n, np.uint32)
    dfs_parent = np.empty(n, np.int32)
    dfs_depth = np.empty(n, np.uint8)
    pos_of = np.empty(n, np.int64)
    r = lib.dfs_layout(n, _p(child_sorted, ctypes.c_uint32),
                       _p(offsets, ctypes.c_int64), root_id,
                       _p(dfs_vec, ctypes.c_uint32),
                       _p(dfs_parent, ctypes.c_int32),
                       _p(dfs_depth, ctypes.c_uint8),
                       _p(pos_of, ctypes.c_int64))
    if r != n:
        raise ValueError(f"dfs_layout reached {r}/{n} nodes")
    return dfs_vec, dfs_parent, dfs_depth, pos_of


def scan_query_native(stream: np.ndarray, n_codes: int, M: int, K: int,
                      table: np.ndarray, top_k: int
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = get_lib()
    if lib is None:
        return None
    stream = np.ascontiguousarray(stream, np.uint8)
    table = np.ascontiguousarray(table, np.float32)
    out_d = np.empty(top_k, np.float32)
    out_i = np.empty(top_k, np.int64)
    r = lib.scan_query(_p(stream, ctypes.c_uint8), n_codes, M, K,
                       _p(table, ctypes.c_float), top_k,
                       _p(out_d, ctypes.c_float), _p(out_i, ctypes.c_int64))
    if r < 0:
        raise ValueError("scan_query failed")
    return out_d[:r], out_i[:r]


def diff_index_decode_native(stream: np.ndarray, n_codes: int, M: int
                             ) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    stream = np.ascontiguousarray(stream, np.uint8)
    out = np.empty((n_codes, M), np.uint8)
    r = lib.diff_index_decode(_p(stream, ctypes.c_uint8), len(stream),
                              n_codes, M, _p(out, ctypes.c_uint8))
    if r < 0:
        raise ValueError("diff_index_decode failed")
    return out

