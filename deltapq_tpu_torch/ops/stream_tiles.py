"""Stream-tile format: packed variable-length delta compression (v2).

A NumPy copy of ``deltapq_tpu/ops/stream_tiles.py``: the port cannot
import the JAX package, whose package import pulls in jax.  The tests
hold its output byte-equal to the original's, and ``StreamTiles.save``
writes the original's on-disk layout, so each package reads the other's
saved tiles.

* ``row_data`` [nT, P, TILE] u8 -- per-row changed-subspace mask planes
  (P = ceil(M/8)), diff vs the previous scan row; the first row of
  every tile is stored full (all-ones mask) so tiles stay
  self-contained;
* ``vals``     -- ONE packed byte stream of all diff values in row-major
  (row, subspace) order, each tile's segment 8-aligned.  Stream
  position p lives at ``vals[p // 1024, p % 8, (p // 8) % 128]``;
* ``meta``     [2, nT] i32 -- per tile the 1024-value window group
  ``w0`` and in-window start offset ``rem`` (multiple of 8).

The CUDA stream kernel (``csrc/stream_mins.cu``) reads each row's values
straight from ``vals`` at those positions; ``decode_stream_tiles`` is
the NumPy oracle for its decode.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from .delta_tiles import _mask_planes

TILE = 1024
GROUP = 1024          # values per window group (vals.shape = [A, 8, 128])


def _n_gather(M: int) -> int:
    """8-value chunks a single row's values can span (offset 0..7 +
    up to M values)."""
    return (7 + M + 7) // 8


def window_groups(M: int, e_max: int) -> int:
    """Static DMA window size (in GROUP-value groups) covering any
    tile's stream segment: rem < GROUP plus e_max values plus the
    trailing chunks the last rows' gather planes touch."""
    max_e_idx = (GROUP - 8 + e_max) // 8 + _n_gather(M)
    return max_e_idx // 128 + 1


@dataclass
class StreamTiles:
    """Device-ready packed delta stream (scan order = DFS)."""

    row_data: np.ndarray   # u8 [nT, P, TILE] mask planes
    vals: np.ndarray       # u8 [A_tot, 8, 128] chunked value stream
    meta: np.ndarray       # i32 [2, nT]: (w0 group, rem values)
    n_valid: int
    M: int
    e_max: int             # max per-tile segment length (values)

    @property
    def n_planes(self) -> int:
        return (self.M + 7) // 8

    def nbytes(self) -> int:
        return self.row_data.nbytes + self.vals.nbytes

    def bytes_per_vec(self) -> float:
        return self.nbytes() / max(self.n_valid, 1)

    def save(self, path: str) -> None:
        """Persist the tiles as raw arrays plus a small header (the JAX
        package's layout), reopened by ``load`` (RAM) or
        ``load(mmap=True)`` (disk-backed)."""
        os.makedirs(path, exist_ok=True)
        self.row_data.tofile(os.path.join(path, "row_data.u8"))
        self.vals.tofile(os.path.join(path, "vals.u8"))
        self.meta.astype(np.int32).tofile(os.path.join(path, "meta.i32"))
        with open(os.path.join(path, "header.json"), "w") as f:
            json.dump({"row_data_shape": list(self.row_data.shape),
                       "vals_shape": list(self.vals.shape),
                       "meta_shape": list(self.meta.shape),
                       "n_valid": self.n_valid, "M": self.M,
                       "e_max": self.e_max}, f)

    @classmethod
    def load(cls, path: str, mmap: bool = False) -> "StreamTiles":
        """Reopen saved tiles.  ``mmap=True`` maps ``row_data`` and
        ``vals`` from disk read-only, so host RAM holds only the pages a
        query touches (an engine copies them before an upload)."""
        with open(os.path.join(path, "header.json")) as f:
            h = json.load(f)

        def opener(name, shape):
            p = os.path.join(path, name)
            if mmap:
                return np.memmap(p, np.uint8, "r", shape=tuple(shape))
            return np.fromfile(p, np.uint8).reshape(shape)

        meta = np.fromfile(os.path.join(path, "meta.i32"), np.int32
                           ).reshape(h["meta_shape"])
        return cls(row_data=opener("row_data.u8", h["row_data_shape"]),
                   vals=opener("vals.u8", h["vals_shape"]), meta=meta,
                   n_valid=int(h["n_valid"]), M=int(h["M"]),
                   e_max=int(h["e_max"]))


#: one engine's packed value stream stays addressable through the
#: [2, nT] i32 ``meta``: 2^31 values.  Larger datasets are split into
#: chunks (``bigscale.ChunkedCompressedEngine``).
MAX_STREAM_VALUES = 2 ** 31


def check_stream_capacity(n_values_padded: int) -> None:
    """Explicit capacity guard: fail loudly instead of silently
    wrapping an i32 offset."""
    if n_values_padded >= MAX_STREAM_VALUES:
        raise ValueError(
            f"packed value stream needs {n_values_padded} values; one "
            f"engine's i32 meta addressing caps at "
            f"{MAX_STREAM_VALUES}.  Split the index into chunks "
            f"(16M-row chunks keep each stream ~40x under the bound).")


def _mask_bits(c: np.ndarray) -> np.ndarray:
    """Sequential-diff bits [n_pad, M] with tile-first rows full."""
    n_pad, _ = c.shape
    prev = np.empty_like(c)
    prev[0] = 0
    prev[1:] = c[:-1]
    bits = c != prev
    bits[(np.arange(n_pad) % TILE) == 0] = True
    return bits


def build_stream_tiles(codes: np.ndarray) -> StreamTiles:
    """Pack scan-ordered codes [N, M] u8 (M <= 16, K <= 256) into
    stream tiles.  Padding rows (to a TILE multiple) repeat the last
    row (zero diffs) and are masked at query time via n_valid."""
    codes = np.asarray(codes, np.uint8)
    n, M = codes.shape
    if M > 16:
        raise NotImplementedError("stream tiles require M <= 16 "
                                  "(2 mask planes); use the codes tier")
    P = (M + 7) // 8
    n_pad = -(-n // TILE) * TILE
    c = np.concatenate([codes, np.repeat(codes[-1:], n_pad - n, axis=0)]
                       ) if n_pad != n else codes
    nt = n_pad // TILE

    bits = _mask_bits(c)
    nd = bits.sum(axis=1).astype(np.int64)

    # mask planes
    mask = _mask_planes(bits)                               # [n_pad, P]
    row_data = np.ascontiguousarray(
        mask.reshape(nt, TILE, P).transpose(0, 2, 1))

    # per-tile segment bases (8-aligned) and row offsets
    nd_t = nd.reshape(nt, TILE)
    e_t = nd_t.sum(axis=1)
    e_pad = -(-e_t // 8) * 8
    base = np.zeros(nt, np.int64)
    base[1:] = np.cumsum(e_pad)[:-1]
    w0 = (base // GROUP).astype(np.int32)
    rem = (base % GROUP).astype(np.int32)
    off_in_tile = (np.cumsum(nd_t, axis=1) - nd_t)          # exclusive

    # global value positions, row-major (row asc, subspace asc)
    rows, cols = np.nonzero(bits)
    j = (np.cumsum(bits, axis=1) - bits)[rows, cols]        # rank in row
    tile_of = rows // TILE
    p = base[tile_of] + off_in_tile[tile_of, rows % TILE] + j

    e_max = int(max(e_t.max() if nt else 0, 8))
    w_a = window_groups(M, e_max)
    # exactly covers the furthest window any tile DMAs: [w0, w0 + W_A)
    a_tot = int(base[-1]) // GROUP + w_a
    check_stream_capacity(a_tot * GROUP)
    flat = np.zeros(a_tot * GROUP, np.uint8)
    flat[(p // GROUP) * GROUP + (p % 8) * 128 + (p // 8) % 128] = \
        c[rows, cols]
    vals = flat.reshape(a_tot, 8, 128)

    return StreamTiles(row_data=row_data, vals=vals,
                       meta=np.stack([w0, rem]).astype(np.int32),
                       n_valid=n, M=M, e_max=e_max)


def decode_stream_tiles(st: StreamTiles) -> np.ndarray:
    """NumPy oracle for the kernel decode: reconstruct the scan-ordered
    [n_valid, M] codes from mask planes + packed value stream via the
    same rank/offset arithmetic + forward fill."""
    nt, P, T = st.row_data.shape
    M = st.M
    planes = st.row_data.astype(np.uint32)                  # [nT, P, T]
    bit = np.stack(
        [(planes[:, m // 8, :] >> (m % 8)) & 1 for m in range(M)],
        axis=2).astype(np.int64)                            # [nT, T, M]
    rank = np.cumsum(bit, axis=2) - bit
    nd = bit.sum(axis=2)                                    # [nT, T]
    off = np.cumsum(nd, axis=1) - nd

    flat = st.vals.reshape(-1)
    base = (st.meta[0].astype(np.int64) * GROUP
            + st.meta[1].astype(np.int64))

    t_i, r_i, m_i = np.nonzero(bit)
    p = base[t_i] + off[t_i, r_i] + rank[t_i, r_i, m_i]
    v = flat[(p // GROUP) * GROUP + (p % 8) * 128 + (p // 8) % 128]

    H = np.full((nt, T, M), -1, np.int32)
    H[t_i, r_i, m_i] = v
    s = 1
    while s < T:
        shifted = np.full_like(H, -1)
        shifted[:, s:] = H[:, :-s]
        H = np.where(H >= 0, H, shifted)
        s *= 2
    assert (H >= 0).all(), "tile row 0 must be a full (all-ones) row"
    return H.reshape(nt * T, M)[:st.n_valid].astype(np.uint8)
