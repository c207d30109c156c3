"""PQ-code binary file I/O, byte-compatible with the reference.

A NumPy copy of ``deltapq_tpu/io/codes.py``; the tests hold the bytes
equal both ways.

Format (``PQTree::Write`` ``pq_tree.cpp:1011-1031`` / ``Read``
``pq_tree.cpp:1032-1081``): ``int64 N`` header (C ``long`` on LP64),
then N*M bytes of codes (two bytes per sub-code little-endian when
K>256; when ``with_id`` each record carries 4 extra id bytes appended
after the M code bytes, ``deltapq_approx_tree_main.cpp:186-264``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def write_codes(path: str, codes: np.ndarray,
                ids: Optional[np.ndarray] = None) -> None:
    """codes: [N, M] uint8 or uint16; ids: optional [N] uint32/int32."""
    codes = np.asarray(codes)
    n, m = codes.shape
    if codes.dtype == np.uint16:
        body = codes.astype("<u2").view(np.uint8).reshape(n, 2 * m)
        if ids is not None:
            raise NotImplementedError("K>256 with_id not supported "
                                      "(matches reference pq_tree.cpp:1053-1056)")
    elif codes.dtype == np.uint8:
        body = codes
        if ids is not None:
            idb = np.asarray(ids, dtype="<i4").view(np.uint8).reshape(n, 4)
            body = np.concatenate([body, idb], axis=1)
    else:
        raise TypeError(f"codes dtype must be uint8/uint16, got {codes.dtype}")
    with open(path, "wb") as f:
        np.int64(n).tofile(f)
        body.tofile(f)


def read_codes(path: str, M: int, K: int = 256, with_id: bool = False,
               top_n: int = -1) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (codes [N, M], ids or None)."""
    with open(path, "rb") as f:
        n = int(np.fromfile(f, dtype=np.int64, count=1)[0])
        if top_n >= 0:
            n = min(n, top_n)
        if K > 256:
            rec = 2 * M
        else:
            rec = M + (4 if with_id else 0)
        raw = np.fromfile(f, dtype=np.uint8, count=n * rec).reshape(n, rec)
    if K > 256:
        codes = np.ascontiguousarray(raw).view("<u2").reshape(n, M)
        return codes, None
    codes = raw[:, :M].copy()
    ids = None
    if with_id:
        ids = np.ascontiguousarray(raw[:, M:]).view("<i4").ravel().copy()
    return codes, ids
