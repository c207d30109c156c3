"""Codeword (codebook) text I/O, byte-compatible with the reference.

A copy of ``deltapq_tpu/io/codewords.py``; the tests hold the bytes
equal both ways.

Format (``PQ::WriteCodewords`` ``pq.cpp:267-286`` / ``ReadCodewords``
``pq.cpp:288-312``): first line ``M,Ks,Ds``; then for each subspace m a
line ``m:`` followed by Ks lines of Ds comma-separated floats (trailing
comma per value).  Keeping the format identical lets codebooks trained by
either implementation be cross-loaded for parity checks.
"""

from __future__ import annotations

import numpy as np


def write_codewords(path: str, codewords: np.ndarray) -> None:
    """codewords: float array [M, K, Ds]."""
    cw = np.asarray(codewords, dtype=np.float32)
    M, K, Ds = cw.shape
    with open(path, "w") as f:
        f.write(f"{M},{K},{Ds}\n")
        for m in range(M):
            f.write(f"{m}:\n")
            for k in range(K):
                # reference streams floats via operator<< (6 significant
                # digits default); we keep full repr for exactness and
                # accept either on read.
                f.write(",".join(repr(float(v)) for v in cw[m, k]) + ",\n")


def read_codewords(path: str) -> np.ndarray:
    """Returns float32 [M, K, Ds]; accepts files written by the reference."""
    with open(path) as f:
        header = f.readline().strip().rstrip(",")
        M, K, Ds = (int(x) for x in header.split(","))
        out = np.empty((M, K, Ds), dtype=np.float32)
        for m in range(M):
            tag = f.readline().strip()
            if not tag.startswith(f"{m}:"):
                raise ValueError(f"{path}: expected subspace header {m}:, got {tag!r}")
            for k in range(K):
                row = f.readline().strip().rstrip(",")
                vals = np.array([float(x) for x in row.split(",")],
                                dtype=np.float32)
                if vals.size != Ds:
                    raise ValueError(f"{path}: row m={m} k={k} has {vals.size} values, want {Ds}")
                out[m, k] = vals
    return out
