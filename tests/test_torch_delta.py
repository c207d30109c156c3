"""The port's tree pieces behind the CLI (the diff index, edge-finding
method 3, the embedded-id tree, the sequential DTC scan) and its
level-wise compressed query (``ops/delta.py``) against the JAX
package's, on the same NumPy inputs."""

import numpy as np
import pytest
import torch

from deltapq_tpu.ops import adc as jadc
from deltapq_tpu.ops import delta as jdelta
from deltapq_tpu.tree import build as jbuild
from deltapq_tpu.tree import layout as jlayout
from deltapq_tpu.tree import serialize as jser
from deltapq_tpu.tree import traverse as jtrav
from deltapq_tpu.tree import with_id as jwid
from deltapq_tpu_torch.ops import adc as padc
from deltapq_tpu_torch.ops import delta as pdelta
from deltapq_tpu_torch.tree import build as pbuild
from deltapq_tpu_torch.tree import layout as playout
from deltapq_tpu_torch.tree import serialize as pser
from deltapq_tpu_torch.tree import traverse as ptrav
from deltapq_tpu_torch.tree import with_id as pwid

from _torch_port import (CPU, assert_ids_up_to_ties, codebook,
                         structured_codes)

TREE_FIELDS = ("vec_id", "parent_pos", "depth", "diff_num", "diff_off",
               "diff_m", "diff_to", "child_pos_start", "child_num",
               "max_dist", "max_dist2p")


def _assert_same_tree(a, b):
    for f in TREE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.root_id, a.M, a.K) == (b.root_id, b.M, b.K)


@pytest.mark.parametrize("K", [256, 1024])
def test_diff_index_bytes_and_decode_equal(tmp_path, K):
    rng = np.random.default_rng(K)
    codes = structured_codes(rng, 2000, 8, min(K, 256))
    if K > 256:
        codes = (codes.astype(np.uint16) * 3 + rng.integers(
            0, 2, codes.shape)).astype(np.uint16)
    jb = jser.serialize_diff_index(codes)
    pb = pser.serialize_diff_index(codes)
    assert jb == pb
    stream = np.frombuffer(pb, np.uint8)
    got = pser.decode_diff_index(stream, len(codes), 8, K)
    assert got.dtype == codes.dtype and np.array_equal(got, codes)
    assert np.array_equal(got, jser.decode_diff_index(stream, len(codes), 8,
                                                      K))
    pj, pp = str(tmp_path / "j"), str(tmp_path / "p")
    jser.write_diff_index(pj, codes)
    pser.write_diff_index(pp, codes)
    assert open(pj, "rb").read() == open(pp, "rb").read()


@pytest.mark.parametrize("M,K,tables", [(8, 256, True), (8, 256, False),
                                        (4, 32, True), (4, 16, False)])
def test_method3_edges_equal(M, K, tables):
    rng = np.random.default_rng(M * K)
    codes = structured_codes(rng, 3000, M, K)
    cw = codebook(rng, M, K, 4)
    tab = playout.mkk_tables(cw) if tables else None
    a = jbuild.find_edges_by_diff(codes, K=K, method=3, tables=tab)
    b = pbuild.find_edges_by_diff(codes, K=K, method=3, tables=tab)
    assert np.array_equal(a.edges, b.edges)
    assert (a.root_id, a.n_diffs) == (b.root_id, b.n_diffs)
    assert np.array_equal(a.heights, b.heights)
    assert np.array_equal(a.finalists, b.finalists)
    if tables:
        # the table distances moved children off the height parent
        m1 = pbuild.find_edges_by_diff(codes, K=K, method=1)
        assert not np.array_equal(m1.edges, b.edges)
    ta = jlayout.build_layout(codes, a.edges, a.root_id, K=K, codewords=cw)
    tb = playout.build_layout(codes, b.edges, b.root_id, K=K, codewords=cw)
    _assert_same_tree(ta, tb)
    assert np.array_equal(tb.decode_codes(), codes)


def test_tree_with_id_equal():
    rng = np.random.default_rng(9)
    codes = structured_codes(rng, 1500, 4, 32)
    cw = codebook(rng, 4, 32, 4)
    ext = pwid.append_id_bytes(codes)
    assert np.array_equal(ext, jwid.append_id_bytes(codes))
    c, ids = pwid.split_id_bytes(ext)
    assert np.array_equal(c, codes) and np.array_equal(ids, np.arange(1500))
    for method in (1, 3):
        ta = jwid.build_tree_with_id(codes, K=32, codewords=cw, method=method)
        tb = pwid.build_tree_with_id(codes, K=32, codewords=cw, method=method)
        _assert_same_tree(ta, tb)
        assert np.array_equal(tb.decode_codes(), ext)
    table = rng.normal(size=(3, 4, 32)).astype(np.float32)
    assert np.array_equal(pwid.extend_table_for_id(table),
                          jwid.extend_table_for_id(table))
    with pytest.raises(NotImplementedError):
        pwid.build_tree_with_id(codes.astype(np.uint16), K=1024,
                                codewords=cw)


@pytest.fixture(scope="module")
def tree_case():
    """A method-1 tree with the pruning bounds over structured codes,
    its codebook and a few queries."""
    rng = np.random.default_rng(21)
    M, K, Ds = 8, 32, 3
    codes = structured_codes(rng, 3000, M, K)
    cw = codebook(rng, M, K, Ds)
    res = pbuild.find_edges_by_diff(codes, K=K)
    tree = playout.build_layout(codes, res.edges, res.root_id, K=K,
                                codewords=cw)
    q = (rng.normal(size=(7, M * Ds)) * 3 + 1).astype(np.float32)
    table = np.array(jadc.adc_table(cw, q))
    return codes, cw, tree, q, table


def test_scan_compressed_equal(tree_case):
    codes, cw, tree, q, table = tree_case
    stream = np.frombuffer(pser.serialize_dtc(tree), np.uint8)
    for b in range(3):
        t64 = table[b].astype(np.float64)
        d, ids = ptrav.scan_compressed(stream, tree.n, tree.M, t64, 10,
                                       vec_id=tree.vec_id)
        jd, jids = jtrav.scan_compressed(stream, tree.n, tree.M, t64, 10,
                                         vec_id=tree.vec_id)
        assert np.array_equal(d, jd) and np.array_equal(ids, jids)


def test_delta_pack_equal(tree_case):
    _, _, tree, _, _ = tree_case
    a, b = jdelta.build_delta_pack(tree), pdelta.build_delta_pack(tree)
    assert (a.n, a.M, a.K) == (b.n, b.M, b.K) and len(a.levels) == len(
        b.levels)
    assert np.array_equal(a.root_code, b.root_code)
    assert np.array_equal(a.db_to_lm, b.db_to_lm)
    for la, lb in zip(a.levels, b.levels):
        for f in ("parent_local", "seg", "dm", "dfrom", "dto"):
            x, y = getattr(la, f), getattr(lb, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_levelwise_dists_equal_plain_adc(tree_case):
    """Every row's distance, against the plain ADC sums of its code and
    against the JAX traversal: f32 sums in other orders."""
    codes, _, tree, _, table = tree_case
    pack = pdelta.build_delta_pack(tree)
    got = pdelta.make_compressed_query_fn(pack, CPU)(
        torch.from_numpy(table)).numpy()
    t64 = table.astype(np.float64)
    full = t64[:, np.arange(tree.M)[None, :], codes.astype(np.int64)].sum(2)
    np.testing.assert_allclose(got, full, rtol=1e-5, atol=1e-4)
    jrun = jdelta.make_compressed_query_fn(jdelta.build_delta_pack(tree))
    np.testing.assert_allclose(got, np.asarray(jrun(table)), rtol=1e-5,
                               atol=1e-4)


def test_query_compressed_matches_jax_and_plain(tree_case):
    codes, cw, tree, q, table = tree_case
    pack = pdelta.build_delta_pack(tree)
    d, ids = pdelta.query_compressed(pack, cw, q, top_k=10, device=CPU)
    assert d.shape == (len(q), 10) and d.dtype == np.float32
    jd, jids = jdelta.query_compressed(jdelta.build_delta_pack(tree), cw, q,
                                       top_k=10)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)
    assert_ids_up_to_ties(table, codes, ids, np.asarray(jids), 10)
    # the port's exact scan over the decoded codes
    tab = padc.adc_table(torch.from_numpy(cw), torch.from_numpy(q))
    pd, pi = padc.adc_query_topk(
        tab, padc.pad_codes(torch.from_numpy(tree.decode_codes()), 1024),
        len(codes), 10, 1024)
    np.testing.assert_allclose(d, pd.numpy(), rtol=1e-5, atol=1e-4)
    assert_ids_up_to_ties(table, codes, ids, pi.numpy(), 10)
    # the reference's sequential DFS-stack scan, in f64
    stream = np.frombuffer(pser.serialize_dtc(tree), np.uint8)
    for b in range(2):
        sd, sids = ptrav.scan_compressed(stream, tree.n, tree.M,
                                         table[b].astype(np.float64), 10,
                                         vec_id=tree.vec_id)
        np.testing.assert_allclose(d[b], sd, rtol=1e-5, atol=1e-4)
        assert_ids_up_to_ties(table[b:b + 1], codes, ids[b:b + 1],
                              sids[None], 10)
