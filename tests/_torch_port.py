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
