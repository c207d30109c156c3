"""The reference against a brute-force NumPy ADC top-k at a tiny size."""

import numpy as np
import pytest
import torch

from benchmark import reference


def _case(seed, M=4, K=16, Ds=3, n=500, q=17):
    rng = np.random.default_rng(seed)
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    codes = rng.integers(0, K, size=(n, M)).astype(np.uint8)
    queries = rng.normal(size=(q, M * Ds)).astype(np.float32)
    return cw, codes, queries


def _brute(cw, codes, queries):
    M, K, Ds = cw.shape
    x = cw[np.arange(M)[None, :], codes.astype(np.int64)]   # [n, M, Ds]
    x = x.reshape(len(codes), M * Ds).astype(np.float64)
    d = ((queries.astype(np.float64)[:, None, :] - x[None]) ** 2).sum(-1)
    return d


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_exact_topk_equals_brute_force(seed, k):
    cw, codes, queries = _case(seed)
    full = _brute(cw, codes, queries)
    d, i = reference.exact_topk(cw, codes, queries, k, "cpu", q_block=5,
                                r_block=96)
    want = np.sort(full, axis=1)[:, :k]
    np.testing.assert_allclose(d, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.take_along_axis(full, i, 1), want,
                               rtol=1e-12, atol=1e-12)


def test_dists_of_reads_each_id_and_marks_bad_ones():
    cw, codes, queries = _case(3)
    full = _brute(cw, codes, queries)
    ids = np.random.default_rng(4).integers(0, len(codes), (len(queries), 7))
    ids[0, 0], ids[1, 1] = -1, len(codes)
    d = reference.dists_of(cw, codes, queries, ids, "cpu", q_block=4)
    ok = (ids >= 0) & (ids < len(codes))
    np.testing.assert_allclose(d[ok], np.take_along_axis(
        full, np.where(ok, ids, 0), 1)[ok], rtol=1e-12)
    assert np.isinf(d[~ok]).all()


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -1.0 - 3 * 2 ** -11, 0.0, 1e-30])
    got = reference.round_tf32(x).tolist()
    assert got[:5] == [1.0, 1.0, 1.0 + 2 ** -9, -1.0 - 2 ** -9, 0.0]
    r = torch.randn(4096)
    rel = ((reference.round_tf32(r) - r).abs() / r.abs()).max().item()
    assert 2 ** -12 < rel <= 2 ** -11


def test_control_answers_near_but_not_exact():
    cw, codes, queries = _case(5, M=8, K=16, Ds=16, n=2000, q=32)
    cw = cw * 4 + 3     # norms well above the distances, as in the cells
    queries = queries * 4 + 3
    d_ref, _ = reference.exact_topk(cw, codes, queries, 10, "cpu")
    d_c, _ = reference.control_topk(cw, codes, queries, 10, "cpu")
    gap = np.abs(d_c - d_ref).max() / d_ref[:, -1].min()
    assert 1e-6 < gap < 0.1
