"""Delta-tile format (v1, fixed slots): a NumPy copy of
``deltapq_tpu/ops/delta_tiles.py``.

The port cannot import the JAX package (its package import pulls in
jax); the tests hold this copy's output byte-equal to the original's.

* rows are the scan-ordered (DeltaTree-DFS) codes, split into tiles of
  ``TILE`` rows;
* each row stores its diff against the previous row as ``ceil(M/8)``
  mask byte planes plus ``S`` fixed value slots (the j-th changed
  subspace's new code in slot j);
* rows with more than ``S`` diffs -- and always the first row of every
  tile, so tiles stay self-contained -- store their full code in the
  tile's overflow bank and an all-ones mask.

The CUDA kernel ``csrc/delta_mins.cu`` (B5) decodes a tile into shared
memory (slot scatter, overflow rank, forward fill) and runs the shared
scan tail on it; ``decode_delta_tiles`` is the NumPy oracle for its
decode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

TILE = 1024


@dataclass
class DeltaTiles:
    """Device-ready delta-compressed code tiles (scan order = DFS)."""

    row_data: np.ndarray   # u8 [nT, P+S, TILE]: P = ceil(M/8) mask byte
                           # planes + S value slots
    ovf: np.ndarray        # u8 [nT, M, Cap]: full codes of overflow rows
    n_valid: int           # true database size (padding rows after)
    M: int
    S: int
    Cap: int

    @property
    def n_planes(self) -> int:
        return (self.M + 7) // 8

    @property
    def n_tiles(self) -> int:
        return self.row_data.shape[0]

    @property
    def n_pad(self) -> int:
        return self.n_tiles * TILE

    def nbytes(self) -> int:
        return self.row_data.nbytes + self.ovf.nbytes

    def bytes_per_vec(self) -> float:
        return self.nbytes() / max(self.n_valid, 1)


def _mask_planes(bits: np.ndarray) -> np.ndarray:
    """[N, M] bool -> [N, ceil(M/8)] uint8 planes: plane p bit j set
    iff bits[:, 8p + j]."""
    n, M = bits.shape
    P = (M + 7) // 8
    out = np.zeros((n, P), np.uint8)
    for p in range(P):
        sub = bits[:, 8 * p:8 * p + 8]
        w = (1 << np.arange(sub.shape[1], dtype=np.uint32))[None, :]
        out[:, p] = (sub.astype(np.uint32) * w).sum(axis=1).astype(
            np.uint8)
    return out


def _full_planes(M: int) -> np.ndarray:
    """All-ones mask planes for overflow rows ([P] u8)."""
    P = (M + 7) // 8
    return np.array([(1 << min(8, M - 8 * p)) - 1 for p in range(P)],
                    np.uint8)


def build_delta_tiles(codes: np.ndarray, S: Optional[int] = None,
                      cap_unit: int = 128) -> DeltaTiles:
    """Pack scan-ordered codes [N, M] u8 (M <= 16, K <= 256) into delta
    tiles.  ``S``: value slots per row (None picks the S in [1,
    min(8, M-1)] minimizing total bytes).  Padding rows (to a TILE
    multiple) repeat the last row (zero diffs); they are masked at query
    time via n_valid."""
    codes = np.asarray(codes, np.uint8)
    n, M = codes.shape
    if M > 16:
        raise NotImplementedError("delta tiles require M <= 16 "
                                  "(2 mask planes); use the codes tier")
    P = (M + 7) // 8
    if S is not None and not (1 <= S <= M - 1):
        # overflow rows are detected by popcount(mask) > S with an
        # all-ones mask (popcount M); S >= M breaks that detection
        raise ValueError(f"S must be in [1, M-1], got {S} (M={M})")
    n_pad = -(-n // TILE) * TILE
    c = np.concatenate([codes, np.repeat(codes[-1:], n_pad - n, axis=0)]
                       ) if n_pad != n else codes
    nt = n_pad // TILE

    prev = np.empty_like(c)
    prev[0] = 0
    prev[1:] = c[:-1]
    bits = c != prev
    first = (np.arange(n_pad) % TILE) == 0
    bits[first] = True
    nd = bits.sum(axis=1)

    def cap_for(s: int) -> int:
        ovf = first | (nd > s)
        per_tile = ovf.reshape(nt, TILE).sum(axis=1)
        return int(-(-per_tile.max() // cap_unit) * cap_unit)

    if S is None:
        best = None
        for s in range(1, min(8, M - 1) + 1):
            total = n_pad * (P + s) + nt * cap_for(s) * M
            if best is None or total < best[0]:
                best = (total, s)
        S = best[1]
    Cap = cap_for(S)

    is_ovf = first | (nd > S)
    mask = np.where(is_ovf[:, None], _full_planes(M)[None, :],
                    _mask_planes(bits))                     # [n_pad, P]

    rank = np.cumsum(bits, axis=1) - bits      # exclusive per-row rank
    slots = np.zeros((n_pad, S), np.uint8)
    fixed = bits & ~is_ovf[:, None]
    for j in range(S):
        rows, cols = np.nonzero(fixed & (rank == j))
        slots[rows, j] = c[rows, cols]

    row_data = np.ascontiguousarray(
        np.concatenate([mask.astype(np.uint8), slots], axis=1)
        .reshape(nt, TILE, P + S).transpose(0, 2, 1))

    ovf_flags = is_ovf.reshape(nt, TILE)
    ovf_rank = np.cumsum(ovf_flags, axis=1) - ovf_flags
    ovf = np.zeros((nt, Cap, M), np.uint8)
    t_idx, r_idx = np.nonzero(ovf_flags)
    ovf[t_idx, ovf_rank[t_idx, r_idx]] = c.reshape(nt, TILE, M)[
        t_idx, r_idx]
    ovf = np.ascontiguousarray(ovf.transpose(0, 2, 1))

    return DeltaTiles(row_data=row_data, ovf=ovf, n_valid=n, M=M, S=S,
                      Cap=Cap)


def decode_delta_tiles(dt: DeltaTiles) -> np.ndarray:
    """NumPy oracle for the kernel decode: the scan-ordered [n_valid, M]
    codes via the slot scatter, the overflow bank and the forward fill
    down the rows."""
    nt, _, T = dt.row_data.shape
    M, S, P = dt.M, dt.S, dt.n_planes

    planes = dt.row_data[:, :P, :].astype(np.uint32)        # [nT, P, T]
    bit = np.stack(
        [(planes[:, m // 8, :] >> (m % 8)) & 1 for m in range(M)],
        axis=2).astype(np.int64)                            # [nT, T, M]
    rank = np.cumsum(bit, axis=2) - bit
    nd = bit.sum(axis=2)
    is_ovf = nd > S
    ovf_rank = (np.cumsum(is_ovf, axis=1) - is_ovf)

    H = np.full((nt, T, M), -1, np.int32)
    for j in range(S):
        sel = (bit == 1) & (rank == j) & ~is_ovf[:, :, None]
        vals = dt.row_data[:, P + j, :].astype(np.int32)
        H = np.where(sel, vals[:, :, None], H)
    t_i, r_i = np.nonzero(is_ovf)
    H[t_i, r_i] = dt.ovf.transpose(0, 2, 1)[t_i, ovf_rank[t_i, r_i]]

    # forward-fill down the rows (holes = -1)
    s = 1
    while s < T:
        shifted = np.full_like(H, -1)
        shifted[:, s:] = H[:, :-s]
        H = np.where(H >= 0, H, shifted)
        s *= 2
    assert (H >= 0).all(), "tile row 0 must be a full (overflow) code"
    return H.reshape(nt * T, M)[:dt.n_valid].astype(np.uint8)
