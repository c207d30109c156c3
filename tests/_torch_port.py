"""Shared inputs and checks for the port's tests (tests/test_torch_*.py).

Inputs are made with NumPy from a seed and handed to both packages.
"""

import numpy as np

#: the port's entry points run on the card unless asked otherwise; the
#: CPU tests ask for the CPU
CPU = "cpu"


def structured_codes(rng, n, M, K):
    """Delta-compressible codes: repeated rows + sparse flips."""
    base = rng.integers(0, K, size=(n, M))
    codes = np.repeat(base, rng.integers(1, 6, size=n), axis=0)[:n]
    flip = rng.random(codes.shape) < 0.15
    return np.where(flip, rng.integers(0, K, codes.shape), codes
                    ).astype(np.uint8)


def codebook(rng, M, K, Ds):
    return (rng.normal(size=(M, K, Ds)) * 3 + 1).astype(np.float32)


def row_dists64(table, codes, ids):
    """f64 ADC distances [B, k] of rows ``ids`` [B, k] (-1 -> inf)."""
    t = np.asarray(table, np.float64)
    B, M, _ = t.shape
    c = np.asarray(codes, np.int64)[np.clip(ids, 0, None)]   # [B, k, M]
    d = t[np.arange(B)[:, None, None], np.arange(M)[None, None, :], c]
    return np.where(ids >= 0, d.sum(axis=2), np.inf)


def assert_ids_up_to_ties(table, codes, ids, ids_ref, top_k, rtol=1e-5):
    """Ids may differ only through equal-distance ties: every query whose
    id set differs must have a provable f64 near-tie at the top-k
    boundary (the audit of tests/test_reference_parity.py)."""
    t = np.asarray(table, np.float64)
    ci = np.asarray(codes, np.int64)
    M = t.shape[1]
    for b in range(ids.shape[0]):
        if set(ids[b].tolist()) == set(ids_ref[b].tolist()):
            continue
        d64 = t[b, np.arange(M)[None, :], ci].sum(axis=1)
        srt = np.sort(d64)
        gap = (srt[top_k] - srt[top_k - 1]) / max(abs(srt[top_k - 1]),
                                                  1e-12)
        assert gap < rtol, (b, gap)


def assert_ids_carry_dists(table, codes, d, ids, rtol=1e-6):
    """Each returned id's own distance is the one reported beside it."""
    got = row_dists64(table, codes, ids)
    np.testing.assert_allclose(got, d, rtol=rtol, atol=1e-4)


#: ADC tile top-k cases whose selection is easy to get wrong: (name, B, M,
#: K, n_valid, tile, top_k).  "ties": rows 5 and 600 of a 1024-row tile
#: share the value at the top_k-th place, behind nine rows of one smaller
#: value spread over the tile; "empty": the last of three 256-row tiles
#: has no valid row and the second 44, fewer than top_k; "int32": K > 256
#: codes, an empty fourth tile, top_k beyond the third tile's valid rows;
#: "deep": top_k = 300, more ranks than the card selects in one launch;
#: "m6": M = 6, a code row that is no whole number of 4-byte words.
ADC_TOPK_CASES = [("ties", 6, 4, 16, 2048, 1024, 10),
                  ("empty", 5, 8, 256, 300, 256, 50),
                  ("int32", 3, 4, 300, 1050, 512, 40),
                  ("deep", 3, 4, 16, 792, 512, 300),
                  ("m6", 4, 6, 64, 520, 256, 12)]


def adc_topk_case(name):
    """(table [B, M, K] f32, codes [n_pad, M] u8 or int32, n_valid, tile,
    top_k) of an ``ADC_TOPK_CASES`` case; rows past n_valid hold random
    codes that must not be selected."""
    _, B, M, K, n_valid, tile, k = next(c for c in ADC_TOPK_CASES
                                        if c[0] == name)
    rng = np.random.default_rng(len(name))
    n_pad = -(-n_valid // tile) * tile + (tile if name != "ties" else 0)
    table = rng.normal(size=(B, M, K)).astype(np.float32) * 10
    codes = rng.integers(2, K, size=(n_pad, M))
    if name == "ties":
        table[:, :, 0] = -100.0       # all-0 rows: -400, nine of them
        table[:, :, 1] = -90.0        # all-1 rows: -360, rows 5 and 600
        for t0 in (0, tile):
            codes[t0 + np.array([1, 70, 200, 333, 512, 700, 801, 950,
                                 1023])] = 0
            codes[t0 + np.array([5, 600])] = 1
    return (table, codes.astype(np.uint8 if K <= 256 else np.int32),
            n_valid, tile, k)


def adc_topk_tiles_model(table, codes, n_valid, top_k, tile, tables):
    """What the tile top-k must give, from NumPy: each row's distance as
    the f32 sum over ascending m of ``tables`` (the values a precision
    adds for each m, each [B, M, K] f32, in order), rows >= n_valid
    dropped; per tile and query the top_k smallest (value, row) pairs
    ordered by value, then row, and (+inf, 0) after the finite ones."""
    B, M, _ = table.shape
    n_pad = codes.shape[0]
    c = codes.astype(np.int64)
    acc = np.zeros((B, n_pad), np.float32)
    for m in range(M):
        for t in tables:
            acc = (acc + t[:, m, c[:, m]]).astype(np.float32)
    nt = n_pad // tile
    out_d = np.full((nt, top_k, B), np.inf, np.float32)
    out_i = np.zeros((nt, top_k, B), np.int32)
    for ti in range(nt):
        rows = np.arange(tile)
        ok = ti * tile + rows < n_valid
        for b in range(B):
            v = acc[b, ti * tile:(ti + 1) * tile]
            keep = ok & np.isfinite(v)
            order = np.lexsort((rows[keep], v[keep]))[:top_k]
            out_d[ti, :len(order), b] = v[keep][order]
            out_i[ti, :len(order), b] = rows[keep][order]
    return out_d, out_i
