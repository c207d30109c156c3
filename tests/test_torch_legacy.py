"""The port's legacy bit-interleaved store and prefix-tree query
(``deltapq_tpu_torch/legacy``) against the JAX package's, on the same
NumPy inputs: equal words, file bytes, bound pyramids and query results;
``dichotomize_codewords`` byte-equal when both packages are handed one
deterministic 2-means, and with the port's own k-means a permutation
whose prefix top-1 equals the plain scan's."""

import importlib

import numpy as np
import pytest
import torch

from deltapq_tpu import legacy as jlegacy
from deltapq_tpu.legacy import prefix_tree as jpt
from deltapq_tpu_torch import legacy as plegacy
from deltapq_tpu_torch.legacy import prefix_tree as ppt
from deltapq_tpu_torch.ops.adc import query_plain
from deltapq_tpu_torch.ops.encode import pq_encode

from _torch_port import CPU, codebook, structured_codes

# the modules (the JAX ops package exports a function of the same name)
jkmeans = importlib.import_module("deltapq_tpu.ops.kmeans")
pkmeans = importlib.import_module("deltapq_tpu_torch.ops.kmeans")


@pytest.mark.parametrize("M,log_k", [(8, 8), (4, 4), (6, 5)])
def test_interleave_equal(M, log_k):
    codes = structured_codes(np.random.default_rng(M), 700, M, 1 << log_k)
    w = plegacy.interleave_codes(codes, log_k)
    assert w.dtype == np.uint64
    assert np.array_equal(w, jlegacy.interleave_codes(codes, log_k))
    back = plegacy.deinterleave_codes(w, M, log_k)
    assert np.array_equal(back, jlegacy.deinterleave_codes(w, M, log_k))
    assert np.array_equal(back, codes)


def test_bitvecs_store_bytes_and_read_equal(tmp_path):
    codes = structured_codes(np.random.default_rng(1), 900, 8, 256)
    s, js = plegacy.BitVecsStore(codes), jlegacy.BitVecsStore(codes)
    assert np.array_equal(s.words, js.words) and np.array_equal(s.ids, js.ids)
    assert s.n == js.n
    s.write(str(tmp_path / "p.bin"))
    js.write(str(tmp_path / "j.bin"))
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    for top_n in (-1, 100):
        r = plegacy.BitVecsStore.read(str(tmp_path / "j.bin"), M=8,
                                      top_n=top_n)
        jr = jlegacy.BitVecsStore.read(str(tmp_path / "p.bin"), M=8,
                                       top_n=top_n)
        assert np.array_equal(r.words, jr.words)
        assert np.array_equal(r.ids, jr.ids) and r.n == jr.n
    u = plegacy.BitVecsStore(codes, sort=False)
    assert np.array_equal(u.words, jlegacy.BitVecsStore(codes,
                                                        sort=False).words)


def test_bound_pyramids_equal():
    table = np.random.default_rng(2).normal(size=(8, 256)).astype(np.float32)
    lo, up = ppt._bound_pyramids(table, 8)
    jlo, jup = jpt._bound_pyramids(table, 8)
    assert sorted(lo) == sorted(jlo)
    for L in lo:
        assert np.array_equal(lo[L], jlo[L]) and np.array_equal(up[L], jup[L])


@pytest.mark.parametrize("M,K,nq", [(8, 256, 2), (8, 16, 6), (4, 256, 6)])
def test_prefix_tree_query_equal(M, K, nq):
    """On an undichotomized random codebook the bounds prune little, so
    the widest case (2^8 children a node, 8 levels) takes few queries."""
    rng = np.random.default_rng(M + K)
    cw = codebook(rng, M, K, 4)
    codes = structured_codes(rng, 1500, M, K)
    log_k = int(np.log2(K))
    s = plegacy.BitVecsStore(codes, log_k=log_k)
    js = jlegacy.BitVecsStore(codes, log_k=log_k)
    rows = codes[rng.integers(0, len(codes), nq)]
    qs = (np.concatenate([cw[m][rows[:, m]] for m in range(M)], 1)
          + rng.normal(size=(nq, M * 4)).astype(np.float32) * 0.5)
    for q in qs:
        for cdb in (None, codes):
            out = plegacy.prefix_tree_query(s, cw, q, codes_db=cdb)
            assert out == jlegacy.prefix_tree_query(js, cw, q, codes_db=cdb)


def _two_means(key, x, K, max_iters=50, n_init=3, **kw):
    """A deterministic 2-means (first point and the point farthest from
    it, then Lloyd steps), for both packages alike."""
    is_t = isinstance(x, torch.Tensor)
    xs = (x.cpu().numpy() if is_t else np.asarray(x)).astype(np.float64)
    c = np.stack([xs[0], xs[np.argmax(((xs - xs[0]) ** 2).sum(1))]])
    for _ in range(10):
        lab = np.argmin(((xs[:, None, :] - c[None]) ** 2).sum(2), axis=1)
        for k in range(2):
            if (lab == k).any():
                c[k] = xs[lab == k].mean(axis=0)
    c = c.astype(np.float32)
    return (torch.from_numpy(c) if is_t else c), None, None


def test_dichotomize_equal_with_one_two_means(monkeypatch):
    monkeypatch.setattr(pkmeans, "kmeans", _two_means)
    monkeypatch.setattr(jkmeans, "kmeans", _two_means)
    cw = codebook(np.random.default_rng(3), 4, 64, 6)
    out = plegacy.dichotomize_codewords(cw, seed=5, max_iters=10,
                                        device=CPU)
    assert out.tobytes() == jlegacy.dichotomize_codewords(
        cw, seed=5, max_iters=10).tobytes()
    assert not np.array_equal(out, cw)


def test_dichotomize_with_port_kmeans_prefix_top1(small_dataset):
    x = small_dataset[:800]
    gen = torch.Generator().manual_seed(0)
    cw = pkmeans.pq_learn(gen, x, 8, 256, max_iters=15, device=CPU).numpy()
    cw2 = plegacy.dichotomize_codewords(cw, max_iters=10, device=CPU)
    assert cw2.shape == cw.shape
    for m in range(cw.shape[0]):
        a = np.sort(cw[m].view([("", cw.dtype)] * cw.shape[2]), axis=0)
        b = np.sort(cw2[m].view([("", cw.dtype)] * cw.shape[2]), axis=0)
        assert np.array_equal(a, b)                     # a permutation
    codes = pq_encode(torch.from_numpy(cw2), torch.from_numpy(x)).numpy()
    store = plegacy.BitVecsStore(codes)
    queries = x[:20] + 0.02
    d_ref, _ = query_plain(cw2, queries, codes, top_k=1, engine="xla",
                           device=CPU)
    for b in range(len(queries)):
        _, dist, stats = plegacy.prefix_tree_query(store, cw2, queries[b],
                                                   codes_db=codes)
        assert abs(dist - float(d_ref[b, 0])) < 1e-3
        assert stats["nodes_expanded"] > 0


def test_legacy_exports_equal():
    assert sorted(plegacy.__all__) == sorted(jlegacy.__all__)
