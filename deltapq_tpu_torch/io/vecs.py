"""Readers/writers for the TEXMEX ``.fvecs`` / ``.bvecs`` / ``.ivecs`` formats.

A NumPy copy of ``deltapq_tpu/io/vecs.py``; the tests hold the bytes
equal both ways.

Format (reference ``utils.cpp:5-71``): each record is ``int32 D`` followed
by ``D`` values — ``float32`` for fvecs, ``uint8`` for bvecs, ``int32``
for ivecs.  The reference streams records one at a time through
``FvecsItrReader::Next`` / ``BvecsItrReader::Next``; here we use
vectorized NumPy reshapes (all records in one file share the same D) and
expose both whole-file/top-N reads and a batched streaming iterator that
replaces the reference's buffer loop (``main.cpp:369-389``).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

_ITEM = {"fvecs": (np.float32, 4), "bvecs": (np.uint8, 1), "ivecs": (np.int32, 4)}


def _ext_of(path: str, ext: Optional[str]) -> str:
    if ext is None:
        ext = os.path.splitext(path)[1].lstrip(".")
    if ext not in _ITEM:
        raise ValueError(f"unsupported vector file extension: {ext!r}")
    return ext


def record_size(dim: int, ext: str) -> int:
    dtype, isize = _ITEM[ext]
    return 4 + dim * isize


def read_dim(path: str, ext: Optional[str] = None) -> int:
    """Read the per-record dimensionality from the first record header."""
    with open(path, "rb") as f:
        d = np.fromfile(f, dtype=np.int32, count=1)
    if d.size != 1 or d[0] <= 0:
        raise ValueError(f"cannot read record dim from {path}")
    return int(d[0])


def num_vectors(path: str, ext: Optional[str] = None) -> int:
    ext = _ext_of(path, ext)
    dim = read_dim(path, ext)
    size = os.path.getsize(path)
    rec = record_size(dim, ext)
    if size % rec != 0:
        raise ValueError(f"{path}: size {size} not a multiple of record {rec}")
    return size // rec


def read_vecs(path: str, ext: Optional[str] = None, top_n: int = -1,
              offset: int = 0, as_float: bool = True) -> np.ndarray:
    """Read ``top_n`` vectors (all if -1) starting at record ``offset``.

    Equivalent to ``ReadTopN`` (``utils.cpp:96-110``); bvecs are converted
    to float32 like ``BvecsItrReader::Next`` (``utils.cpp:60-66``) when
    ``as_float``.
    """
    ext = _ext_of(path, ext)
    dtype, isize = _ITEM[ext]
    dim = read_dim(path, ext)
    rec = record_size(dim, ext)
    total = os.path.getsize(path) // rec
    if top_n < 0:
        top_n = total - offset
    top_n = min(top_n, total - offset)
    with open(path, "rb") as f:
        f.seek(offset * rec)
        raw = np.fromfile(f, dtype=np.uint8, count=top_n * rec)
    raw = raw.reshape(top_n, rec)
    body = np.ascontiguousarray(raw[:, 4:]).view(dtype).reshape(top_n, dim)
    # sanity check headers
    hdr = np.ascontiguousarray(raw[:, :4]).view(np.int32).ravel()
    if not np.all(hdr == dim):
        raise ValueError(f"{path}: inconsistent record dims")
    if as_float and body.dtype != np.float32:
        body = body.astype(np.float32)
    return body


def read_vecs_at(path: str, ids: np.ndarray, ext: Optional[str] = None,
                 as_float: bool = True) -> np.ndarray:
    """Read specific records by index via seek — the reference's
    by-offset re-read pattern (``main.cpp:901-931``) — without loading
    the whole file.  Duplicate ids are read once and fanned back out."""
    ext = _ext_of(path, ext)
    dim = read_dim(path, ext)
    rec = record_size(dim, ext)
    dtype, isize = _ITEM[ext]
    ids = np.asarray(ids, np.int64)
    if (ids < 0).any():
        raise ValueError("read_vecs_at: negative (invalid) ids; "
                         "filter sentinel -1 entries first")
    uniq, inv = np.unique(ids, return_inverse=True)
    out = np.empty((len(uniq), dim),
                   np.float32 if as_float else dtype)
    with open(path, "rb") as f:
        for j, rid in enumerate(uniq):
            f.seek(int(rid) * rec + 4)
            row = np.frombuffer(f.read(rec - 4), dtype=dtype)
            out[j] = row.astype(np.float32) if as_float else row
    return out[inv].reshape(ids.shape + (dim,))


def iter_vec_batches(path: str, ext: Optional[str] = None,
                     batch_size: int = 100_000, top_n: int = -1,
                     as_float: bool = True) -> Iterator[np.ndarray]:
    """Stream batches of vectors (replaces the reference's encode buffer
    loop, ``main.cpp:369-389``, buffer = max(N/2000, 10000))."""
    ext = _ext_of(path, ext)
    total = num_vectors(path, ext)
    if top_n >= 0:
        total = min(total, top_n)
    off = 0
    while off < total:
        n = min(batch_size, total - off)
        yield read_vecs(path, ext, top_n=n, offset=off, as_float=as_float)
        off += n


def write_vecs(path: str, vecs: np.ndarray, ext: Optional[str] = None) -> None:
    """Write vectors in the TEXMEX format (test fixture generation)."""
    ext = _ext_of(path, ext)
    dtype, isize = _ITEM[ext]
    vecs = np.asarray(vecs)
    n, dim = vecs.shape
    body = vecs.astype(dtype)
    rec = np.empty((n, record_size(dim, ext)), dtype=np.uint8)
    rec[:, :4] = np.full((n, 1), dim, np.int32).view(np.uint8)
    rec[:, 4:] = body.view(np.uint8).reshape(n, dim * isize)
    rec.tofile(path)
