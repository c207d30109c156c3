"""The device edge search (``tree.build_device``) run on the CPU against
the reference's ``deltapq_tpu.tree.build.find_edges_by_diff`` and the
port's NumPy copy: every field of ``EdgeFindResult`` equal, and a
``DeltaPQIndex`` built through it equal to one built on the host."""

import numpy as np
import pytest

from deltapq_tpu.tree.build import find_edges_by_diff as j_find
from deltapq_tpu_torch import tracing
from deltapq_tpu_torch.index import DeltaPQIndex
from deltapq_tpu_torch.tree import build as pbuild
from deltapq_tpu_torch.tree.build import find_edges_by_diff, nchoosek
from deltapq_tpu_torch.tree.build_device import find_edges_by_diff_device

from _torch_port import (CPU, EDGE_REFERENCE, codebook, edge_fingerprint,
                         hashed_codes)


def _codes(kind, n, M, K, seed):
    """``distinct``: uniform draws, nearly every row its own code;
    ``dup``: a pool of n/40 codes, 5% of sub-codes redrawn."""
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if K <= 256 else np.uint16
    if kind == "distinct":
        return rng.integers(0, K, (n, M)).astype(dtype)
    pool = rng.integers(0, K, (max(1, n // 40), M))
    c = pool[rng.integers(0, len(pool), n)]
    flip = rng.random(c.shape) < 0.05
    return np.where(flip, rng.integers(0, K, c.shape), c).astype(dtype)


def assert_same_result(a, b):
    assert a.edges.dtype == b.edges.dtype == np.uint32
    assert a.edges.shape == b.edges.shape
    assert np.array_equal(a.edges, b.edges)
    assert a.root_id == b.root_id and a.n_diffs == b.n_diffs
    assert a.heights.dtype == b.heights.dtype
    assert np.array_equal(a.heights, b.heights)
    assert a.finalists.dtype == b.finalists.dtype
    assert np.array_equal(a.finalists, b.finalists)
    assert a.rounds_log == b.rounds_log


GRID = [(kind, n, M, K, method)
        for kind in ("distinct", "dup") for n in (0, 1, 2, 2500)
        for M in (8, 16) for K in (256, 16) for method in (1, 2)]
#: beyond the grid: M=8 keys of 80 bits (K=1024, u16 codes), K=150 whose
#: codes overflow their 7-bit fields into the next (NumPy ORs them), a
#: sampled rate and a short diff range at M=12, three height folds
EXTRA = [("distinct", 2000, 8, 1024, 1), ("dup", 2000, 8, 150, 1),
         ("dup", 2000, 12, 150, 2)]
KW = {("dup", 2000, 12, 150, 2): dict(sample_rate=0.05, diff_argument=6),
      ("dup", 2000, 8, 150, 1): dict(max_height_folds=3)}


@pytest.mark.parametrize("kind,n,M,K,method", GRID + EXTRA)
def test_device_search_equals_host(kind, n, M, K, method):
    codes = _codes(kind, n, M, K, seed=n + M + K + method)
    kw = dict(K=K, method=method, **KW.get((kind, n, M, K, method), {}))
    a = j_find(codes, **kw)
    b = find_edges_by_diff_device(codes, device=CPU, **kw)
    assert_same_result(a, b)
    assert_same_result(a, find_edges_by_diff(codes, **kw))
    if n >= 2 and "diff_argument" not in kw:     # a spanning tree
        assert len(b.edges) == n - 1


@pytest.mark.parametrize("shape", sorted(EDGE_REFERENCE))
def test_reference_at_the_card_shapes(shape):
    """The reference's result on the hashed codes of the card test
    (tests/test_torch_cuda.py ``test_edge_search_on_card_equals_reference``)
    has the fingerprint that test holds the card's search to."""
    n, M, fp = EDGE_REFERENCE[shape]
    assert edge_fingerprint(j_find(hashed_codes(n, M), K=256)) == fp


@pytest.mark.parametrize("M", [8, 16])
def test_hashed_codes_on_the_device_search(M):
    """The card test's code recipe at a small size: device search equal
    to the reference, and rows merged in every round from diff 1 on."""
    codes = hashed_codes(20_000, M)
    a = j_find(codes, K=256)
    b = find_edges_by_diff_device(codes, K=256, device=CPU)
    assert_same_result(a, b)
    assert edge_fingerprint(a) == edge_fingerprint(b)
    after = [r["active_after"] for r in a.rounds_log]
    assert all(x > y for x, y in zip(after, after[1:]))


def test_edge_combos_counts_both_paths():
    """Both paths count every combination drawn in a round that starts
    with two or more active rows."""
    codes = _codes("dup", 1500, 16, 256, seed=5)
    tracing.reset()
    find_edges_by_diff(codes, K=256)
    host = tracing.snapshot()["counters"]["edge_combos"]
    tracing.reset()
    res = find_edges_by_diff_device(codes, K=256, device=CPU)
    dev = tracing.snapshot()["counters"]["edge_combos"]
    tracing.reset()
    assert host == dev == sum(min(64, len(nchoosek(16, 16 - r["diff"])))
                              for r in res.rounds_log)


def test_method_3_and_unknown_methods_refused():
    codes = _codes("dup", 100, 8, 16, seed=1)
    with pytest.raises(NotImplementedError):
        find_edges_by_diff_device(codes, K=16, method=3, device=CPU)
    with pytest.raises(ValueError):
        find_edges_by_diff_device(codes, K=16, method=4, device=CPU)


def test_index_built_through_the_device_search(monkeypatch):
    """The index with the device search in the host search's place on the
    CPU: the same DTC bytes, tree and answers as the NumPy build.  (The
    card picks the device route itself: tests/test_torch_cuda.py
    ``test_index_edge_search_route``.)"""
    rng = np.random.default_rng(3)
    M, K, Ds = 8, 32, 4
    cw = codebook(rng, M, K, Ds)
    codes = _codes("dup", 3000, M, K, seed=3)
    queries = rng.normal(size=(16, M * Ds)).astype(np.float32) * 3 + 1
    host = DeltaPQIndex(cw, codes, engine="fused_compressed", device=CPU)

    calls = []

    def on_device(codes, **kw):
        calls.append(len(codes))
        return find_edges_by_diff_device(codes, device=CPU, **kw)

    monkeypatch.setattr(pbuild, "find_edges_by_diff", on_device)
    dev = DeltaPQIndex(cw, codes, engine="fused_compressed", device=CPU)
    assert calls == [3000]
    assert dev._stream is not None and dev._stream == host._stream
    assert np.array_equal(dev.tree.vec_id, host.tree.vec_id)
    d0, i0 = host.search(queries, top_k=10)
    d1, i1 = dev.search(queries, top_k=10)
    assert np.array_equal(d0, d1) and np.array_equal(i0, i1)
    # compact rebuilds through the same route
    dev.remove([0, 5, 9])
    dev.compact()
    monkeypatch.undo()
    host.remove([0, 5, 9])
    host.compact()
    assert len(calls) == 2 and dev._stream == host._stream

