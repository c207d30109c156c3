"""DTC compressed-code serialization, byte-exact with the reference.

A NumPy copy of the DTC part of ``deltapq_tpu/tree/serialize.py``
(``serialize_dtc``, ``write_dtc``, ``read_dtc_raw``,
``deserialize_dtc``, ``decode_dtc_to_codes``); the port has no native
parser, so the decoders are the Python loops.  The tests hold the bytes
equal to the original's.

Format (K <= 256, M <= 8): file header ``int64 n_codes, int64 n_bytes``;
stream: M root code bytes, then the N-1 non-root nodes in DFS order,
packed two per depth byte: ``[depth1 | depth2<<4][bitmap1][tos1...]
[bitmap2][tos2...]``; a final odd node stores its depth in a full byte.
``bitmap`` bit m set <=> subspace m differs from the parent; the
following bytes are the new centroid ids in ascending subspace order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .layout import DeltaTree, _ragged_indices


def _bitmaps_from_diffs(diff_num, diff_off, diff_m, n_nodes) -> np.ndarray:
    """Per-node bitmap byte from ragged diff subspace indices."""
    cnt = diff_num.astype(np.int64)
    flat = _ragged_indices(diff_off[:n_nodes], cnt)
    rows = np.repeat(np.arange(n_nodes, dtype=np.int64), cnt)
    bm = np.zeros(n_nodes, np.uint8)
    np.bitwise_or.at(bm, rows, (1 << diff_m[flat].astype(np.uint16))
                     .astype(np.uint8))
    return bm


def serialize_dtc(tree: DeltaTree, auto_repair: bool = True) -> bytes:
    """DeltaTree -> DTC byte stream (without the 16-byte file header).

    The paired-depth byte holds 4-bit nibbles, so depth must be <= 15;
    a deeper tree is repaired in place when ``auto_repair``
    (``reroot.repair_tree``): the repair MUTATES ``tree``'s fields so
    the caller's object stays consistent with the emitted stream.
    """
    n = tree.n
    M = tree.M
    if tree.K > 256:
        raise NotImplementedError("DTC byte format is defined for K<=256 "
                                  "(one byte per diff)")
    if M > 8:
        raise NotImplementedError("DTC bitmap is a single byte; M>8 "
                                  "cannot round-trip")
    if n > 1 and int(tree.depth.max()) > 15:
        if not auto_repair:
            raise ValueError(
                f"tree depth {int(tree.depth.max())} exceeds the DTC "
                f"format's 4-bit depth nibble (max 15)")
        from .reroot import repair_tree

        repaired = repair_tree(tree, max_depth=15)
        for f in ("vec_id", "parent_pos", "depth", "diff_num",
                  "diff_off", "diff_m", "diff_to", "child_pos_start",
                  "child_num", "max_dist", "max_dist2p", "root_id"):
            setattr(tree, f, getattr(repaired, f))
    nd = tree.diff_num[1:].astype(np.int64)       # [n-1]
    j = np.arange(n - 1, dtype=np.int64)          # node index within stream
    depth_byte = np.where(j % 2 == 0, 1, 0)       # first of pair carries depth
    if (n - 1) % 2 == 1:
        depth_byte[-1] = 1                        # odd leftover: own byte
    sizes = depth_byte + 1 + nd
    offs = M + np.concatenate([[0], np.cumsum(sizes)])[:-1]
    total = M + int(np.sum(sizes))
    out = np.zeros(total, np.uint8)

    out[:M] = tree.diff_to[:M].astype(np.uint8)   # root code

    depths = tree.depth[1:].astype(np.uint8)
    even = j[j % 2 == 0]
    pair_even = even[even + 1 < n - 1]
    d1 = depths[pair_even]
    d2 = depths[pair_even + 1]
    out[offs[pair_even]] = d1 | (d2 << 4)
    if (n - 1) % 2 == 1:
        out[offs[-1]] = depths[-1]

    bm = _bitmaps_from_diffs(tree.diff_num, tree.diff_off, tree.diff_m, n)[1:]
    out[offs + depth_byte] = bm

    starts = tree.diff_off[1:n]
    flat = _ragged_indices(starts, nd)
    rep_off = np.repeat(offs + depth_byte + 1, nd)
    intra = np.arange(int(nd.sum()), dtype=np.int64) - \
        np.repeat(np.cumsum(nd) - nd, nd)
    out[rep_off + intra] = tree.diff_to[flat].astype(np.uint8)
    return out.tobytes()


def write_dtc(path: str, tree: DeltaTree) -> None:
    stream = serialize_dtc(tree)
    with open(path, "wb") as f:
        np.int64(tree.n).tofile(f)
        np.int64(len(stream)).tofile(f)
        f.write(stream)


def read_dtc_raw(path: str) -> Tuple[int, np.ndarray]:
    with open(path, "rb") as f:
        n_codes = int(np.fromfile(f, np.int64, 1)[0])
        n_bytes = int(np.fromfile(f, np.int64, 1)[0])
        stream = np.fromfile(f, np.uint8, n_bytes)
    return n_codes, stream


_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                          axis=1).sum(axis=1).astype(np.int64)


def deserialize_dtc(stream: np.ndarray, n_codes: int, M: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """Parse a DTC stream -> (depth [N], bitmap [N], diff_to ragged,
    diff_off [N+1]).  Position 0 is the root (depth 0, all M subspaces
    set).  Depth nibbles are read with & 15, as written."""
    stream = np.asarray(stream, np.uint8)
    depths = np.zeros(n_codes, np.uint8)
    bitmaps = np.zeros(n_codes, np.uint8)
    diff_tos = [stream[:M]]
    diff_counts = np.zeros(n_codes, np.int64)
    diff_counts[0] = M
    bitmaps[0] = (1 << M) - 1 if M < 8 else 0xFF
    off = M

    def record(i, depth):
        nonlocal off
        bm = int(stream[off])
        off += 1
        nd = _POPCOUNT[bm]
        depths[i] = depth
        bitmaps[i] = bm
        diff_counts[i] = nd
        diff_tos.append(stream[off:off + nd])
        off += nd

    i = 1
    while i + 1 < n_codes:
        dbyte = int(stream[off])
        off += 1
        record(i, dbyte & 0x0F)
        record(i + 1, (dbyte >> 4) & 0x0F)
        i += 2
    if i == n_codes - 1:
        d = int(stream[off])
        off += 1
        record(i, d)
    diff_off = np.concatenate([[0], np.cumsum(diff_counts)])
    return depths, bitmaps, np.concatenate(diff_tos), diff_off


def decode_dtc_to_codes(stream: np.ndarray, n_codes: int, M: int
                        ) -> np.ndarray:
    """Lossless decode of a DTC stream to the [N, M] code array (row
    order = DFS order; the tree's vec_id maps rows to database ids),
    with the depth-stack discipline of the reference decoder: a node's
    parent state lives at stack[depth-1]."""
    depths, bitmaps, diff_to, diff_off = deserialize_dtc(stream, n_codes, M)
    codes = np.zeros((n_codes, M), np.uint8)
    stack = np.zeros((16 + 2, M), np.uint8)
    stack[0] = diff_to[:M]
    codes[0] = stack[0]
    lut = [np.flatnonzero([(b >> m) & 1 for m in range(8)])
           for b in range(256)]
    for i in range(1, n_codes):
        d = int(depths[i])
        row = stack[d - 1].copy()
        s, e = diff_off[i], diff_off[i + 1]
        row[lut[int(bitmaps[i])]] = diff_to[s:e]
        stack[d] = row
        codes[i] = row
    return codes
