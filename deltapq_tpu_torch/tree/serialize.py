"""DTC compressed-code serialization, byte-exact with the reference.

A NumPy copy of ``deltapq_tpu/tree/serialize.py``: the DTC stream
(``serialize_dtc``, ``write_dtc``, ``read_dtc_raw``, ``deserialize_dtc``,
``decode_dtc_to_codes``; the decoders take the C++ parser of ``native/``
when ``use_native`` and the library is available, else the Python
loops), the sequential diff index, the block-aware size of reference
method 4, the legacy bit format and the row-store variant, with
``query_bits`` and ``query_row_store`` scanning the decoded codes on a
device.  The tests hold the bytes equal to the original's.

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

from ..native import dtc_decode_native, dtc_parse_native
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


def deserialize_dtc(stream: np.ndarray, n_codes: int, M: int,
                    use_native: bool = True,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """Parse a DTC stream -> (depth [N], bitmap [N], diff_to ragged,
    diff_off [N+1]).  Position 0 is the root (depth 0, all M subspaces
    set).  Depth nibbles are read with & 15, as written.  With
    ``use_native`` the C++ parser runs when the library is available
    (its ``ValueError`` on a malformed stream propagates)."""
    if use_native:
        out = dtc_parse_native(stream, n_codes, M)
        if out is not None:
            return out
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


def decode_dtc_to_codes(stream: np.ndarray, n_codes: int, M: int,
                        use_native: bool = True) -> np.ndarray:
    """Lossless decode of a DTC stream to the [N, M] code array (row
    order = DFS order; the tree's vec_id maps rows to database ids),
    with the depth-stack discipline of the reference decoder: a node's
    parent state lives at stack[depth-1].  Takes the C++ decoder when
    ``use_native`` and the library is available."""
    if use_native:
        out = dtc_decode_native(stream, n_codes, M)
        if out is not None:
            return out
    depths, bitmaps, diff_to, diff_off = deserialize_dtc(
        stream, n_codes, M, use_native=False)
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


# --------------------------------------------------------------------------
# Sequential diff index (no tree) — create_diff_index (:1972-2053)
# --------------------------------------------------------------------------

def serialize_diff_index(codes: np.ndarray) -> bytes:
    """Delta each code vs the previous code in file order."""
    codes = np.asarray(codes)
    n, M = codes.shape
    if codes.dtype == np.uint16:
        wide = True
    else:
        wide = False
    diff_mask = np.zeros((n, M), bool)
    diff_mask[0] = False
    diff_mask[1:] = codes[1:] != codes[:-1]
    nd = diff_mask[1:].sum(axis=1).astype(np.int64)
    bytes_per_diff = 2 if wide else 1
    sizes = 1 + nd * bytes_per_diff
    offs = M * bytes_per_diff + np.concatenate([[0], np.cumsum(sizes)])[:-1]
    total = M * bytes_per_diff + int(sizes.sum())
    out = np.zeros(total, np.uint8)
    if wide:
        out[:2 * M] = codes[0].astype("<u2").view(np.uint8)
    else:
        out[:M] = codes[0]
    # bitmaps
    bits = (diff_mask[1:].astype(np.uint16) <<
            np.arange(M, dtype=np.uint16)[None, :]).sum(axis=1)
    out[offs] = bits.astype(np.uint8)
    rows, cols = np.nonzero(diff_mask[1:])
    vals = codes[1:][rows, cols]
    intra = np.arange(len(rows), dtype=np.int64) - \
        np.repeat(np.cumsum(nd) - nd, nd)
    if wide:
        v16 = vals.astype("<u2").view(np.uint8).reshape(-1, 2)
        out[offs[rows] + 1 + 2 * intra] = v16[:, 0]
        out[offs[rows] + 2 + 2 * intra] = v16[:, 1]
    else:
        out[offs[rows] + 1 + intra] = vals.astype(np.uint8)
    return out.tobytes()


def write_diff_index(path: str, codes: np.ndarray) -> None:
    stream = serialize_diff_index(codes)
    with open(path, "wb") as f:
        np.int64(len(codes)).tofile(f)
        np.int64(len(stream)).tofile(f)
        f.write(stream)


def decode_diff_index(stream: np.ndarray, n_codes: int, M: int,
                      K: int = 256) -> np.ndarray:
    """Lossless decode of the sequential diff index."""
    stream = np.asarray(stream, np.uint8)
    wide = K > 256
    popcount = _POPCOUNT
    lut = [np.flatnonzero([(b >> m) & 1 for m in range(8)])
           for b in range(256)]
    dtype = np.uint16 if wide else np.uint8
    codes = np.zeros((n_codes, M), dtype)
    if wide:
        codes[0] = stream[:2 * M].view("<u2")
        off = 2 * M
    else:
        codes[0] = stream[:M]
        off = M
    for i in range(1, n_codes):
        bm = int(stream[off]); off += 1
        nd = popcount[bm]
        row = codes[i - 1].copy()
        ms = lut[bm]
        if wide:
            row[ms] = stream[off:off + 2 * nd].view("<u2")
            off += 2 * nd
        else:
            row[ms] = stream[off:off + nd]
            off += nd
        codes[i] = row
    return codes


def block_aware_size(tree: DeltaTree, block_bytes: int = 4096) -> dict:
    """Block-aware packing size (reference method 4,
    ``qnodes_to_compressed_codes_opt_block_aware``): DFS node records
    packed greedily into fixed blocks, each also holding a 10-bit node
    count and its entry node's full code so blocks decode on their own.
    Returns the block count and bytes (a measurement; the reference
    prints it and exits)."""
    n = tree.n
    M = tree.M
    nd = tree.diff_num[1:].astype(np.int64)
    # per node: ~0.5 B shared depth nibble + 1 B bitmap + diffs
    rec = 1.5 + 1 + nd
    header = 2 + M  # 10-bit count (2 B) + entry code
    blocks = 1
    used = header + M  # the first block carries the root code
    for r in rec:
        if used + r > block_bytes:
            blocks += 1
            used = header
        used += r
    return {"blocks": blocks, "bytes": blocks * block_bytes,
            "plain_bytes": n * M}


# --------------------------------------------------------------------------
# Legacy bit-level format -- qnodes_to_compressed_codes (:1498-1596)
# --------------------------------------------------------------------------

def serialize_bits(tree: DeltaTree) -> Tuple[bytes, int]:
    """Legacy bit format: per node (root included) 3-bit depth + 8-bit
    bitmap + 8 bits per diff "to", bits packed LSB-first.  Returns
    (bytes, n_bits)."""
    n, M = tree.n, tree.M
    if M > 8:
        raise NotImplementedError("bit format bitmap is 8 bits")
    bm = _bitmaps_from_diffs(tree.diff_num, tree.diff_off, tree.diff_m, n)
    depth = tree.depth.astype(np.uint8)
    nd = tree.diff_num.astype(np.int64)
    total_bits = int(3 * n + 8 * n + 8 * nd.sum())
    out = np.zeros(total_bits, np.uint8)
    pos = 0
    for i in range(n):
        d = int(depth[i])
        out[pos:pos + 3] = [(d >> j) & 1 for j in range(3)]
        pos += 3
        b = int(bm[i])
        out[pos:pos + 8] = [(b >> j) & 1 for j in range(8)]
        pos += 8
        s, e = tree.diff_off[i], tree.diff_off[i + 1]
        for v in tree.diff_to[s:e]:
            v = int(v)
            out[pos:pos + 8] = [(v >> j) & 1 for j in range(8)]
            pos += 8
    packed = np.packbits(out, bitorder="little")
    return packed.tobytes(), total_bits


def deserialize_bits(stream: bytes, n_bits: int, n_codes: int, M: int
                     ) -> np.ndarray:
    """Decode the legacy bit format back to [N, M] codes in DFS order."""
    bits = np.unpackbits(np.frombuffer(stream, np.uint8),
                         bitorder="little")[:n_bits]
    codes = np.zeros((n_codes, M), np.uint8)
    stack = np.zeros((16, M), np.uint8)
    pos = 0

    def take(k):
        nonlocal pos
        v = 0
        for j in range(k):
            v |= int(bits[pos + j]) << j
        pos += k
        return v

    for i in range(n_codes):
        d = take(3)
        bm = take(8)
        row = stack[d - 1].copy() if i else np.zeros(M, np.uint8)
        for m in range(8):
            if bm & (1 << m):
                row[m] = take(8)
        stack[d] = row
        codes[i] = row
    return codes


# --------------------------------------------------------------------------
# Row-store variant -- row_store_qnodes_to_compressed_codes_opt (:1598-1729)
# --------------------------------------------------------------------------

def _record_ends(tree: DeltaTree) -> np.ndarray:
    """Stream offset just past each node's record in ``serialize_dtc``'s
    layout: [N] (the root's M code bytes, then each node's optional depth
    byte, bitmap and diffs)."""
    n, M = tree.n, tree.M
    j = np.arange(n - 1, dtype=np.int64)
    depth_byte = (j % 2 == 0).astype(np.int64)
    sizes = depth_byte + 1 + tree.diff_num[1:].astype(np.int64)
    return np.concatenate([[M], M + np.cumsum(sizes)])


def serialize_dtc_row_store(tree: DeltaTree, raw_vectors: np.ndarray
                            ) -> bytes:
    """DTC byte format with each node's raw vector bytes written right
    after its record (the reference's row-store variant, for systems
    that keep raw data beside the codes).  raw_vectors: [N_db, D] uint8
    (bvecs semantics), indexed by database id.  ``serialize_dtc`` may
    repair ``tree`` first, as it does alone."""
    raw = np.asarray(raw_vectors, np.uint8)
    base = np.frombuffer(serialize_dtc(tree), np.uint8)
    n, d_raw = tree.n, raw.shape[1]
    ends = _record_ends(tree)                 # after repair, if any
    # a stream byte at p moves past the raw rows of every record ending
    # at or before p; node j's raw row lands after j earlier raw rows
    shift = np.searchsorted(ends, np.arange(len(base)), side="right")
    out = np.empty(len(base) + n * d_raw, np.uint8)
    out[np.arange(len(base)) + shift * d_raw] = base
    at = ends + np.arange(n, dtype=np.int64) * d_raw
    out[at[:, None] + np.arange(d_raw)] = raw[tree.vec_id.astype(np.int64)]
    return out.tobytes()


def deserialize_dtc_row_store(stream: bytes, n_codes: int, M: int,
                              d_raw: int):
    """Decode the row-store stream back to (codes [N, M] u8 DFS order,
    raw vectors [N, d_raw] u8 DFS order): one walk over the record
    sizes finds every raw row, which leaves a plain DTC stream for
    ``decode_dtc_to_codes``."""
    s = np.frombuffer(stream, np.uint8)
    b = bytes(stream)
    pc = _POPCOUNT.tolist()
    raw_at = np.empty(n_codes, np.int64)
    raw_at[0] = M
    off = M + d_raw
    i = 1
    while i < n_codes:
        pair = min(2, n_codes - i)
        off += 1                                  # depth byte
        for h in range(pair):
            off += 1 + pc[b[off]]                 # bitmap + diffs
            raw_at[i + h] = off
            off += d_raw
        i += pair
    raw_idx = raw_at[:, None] + np.arange(d_raw)
    keep = np.ones(len(s), bool)
    keep[raw_idx.reshape(-1)] = False
    keep[off:] = False
    codes = decode_dtc_to_codes(s[keep], n_codes, M)
    return codes, s[raw_idx]


def query_row_store(stream: bytes, n_codes: int, M: int, d_raw: int,
                    codewords: np.ndarray, queries: np.ndarray,
                    vec_id: np.ndarray, top_k: int = 10, device=None):
    """Query over the row-store stream: decode (lossless), the plain
    ADC scan on ``device`` (None: the card), and the winners' raw
    vectors.  Returns (dists [B, k], db_ids [B, k], raw_rows
    [B, k, d_raw] u8)."""
    from ..ops.adc import query_plain

    codes, raw = deserialize_dtc_row_store(stream, n_codes, M, d_raw)
    d, rows = query_plain(codewords, queries, codes, top_k=top_k,
                          engine="xla", device=device)
    ids = np.asarray(vec_id, np.int64)[rows]
    return d, ids, raw[rows]


def query_bits(stream: bytes, n_bits: int, n_codes: int, M: int,
               codewords: np.ndarray, queries: np.ndarray,
               vec_id: np.ndarray, top_k: int = 10, device=None):
    """Query over the legacy bit-format stream: lossless decode, then
    the plain ADC scan on ``device`` (None: the card).  Returns (dists,
    db_ids)."""
    from ..ops.adc import query_plain

    codes = deserialize_bits(stream, n_bits, n_codes, M)
    d, rows = query_plain(codewords, queries, codes, top_k=top_k,
                          engine="xla", device=device)
    return d, np.asarray(vec_id, np.int64)[rows]
