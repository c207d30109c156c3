"""The port's table-driven DeltaTree layout, re-rooting and DTC
serialization against the JAX package's (NumPy in both): the same
fields, the same bytes, lossless round trips."""

import numpy as np
import pytest

from deltapq_tpu.tree.build import find_edges_by_diff as j_find
from deltapq_tpu.tree import layout as jlayout
from deltapq_tpu.tree import reroot as jreroot
from deltapq_tpu.tree import serialize as jser
from deltapq_tpu_torch.synth import chain_codes
from deltapq_tpu_torch.tree import layout as player
from deltapq_tpu_torch.tree import reroot as preroot
from deltapq_tpu_torch.tree import serialize as pser
from deltapq_tpu_torch.tree.build import find_edges_by_diff

from _torch_port import codebook, structured_codes

FIELDS = ("vec_id", "parent_pos", "depth", "diff_num", "diff_off", "diff_m",
          "diff_to", "child_pos_start", "child_num", "max_dist",
          "max_dist2p")


def _codes(kind, M, K):
    if kind == "chain":
        return chain_codes(2000, M=M, K=K, seed=3)
    return structured_codes(np.random.default_rng(M * K), 3000, M, K)


def _assert_same_tree(ta, tb):
    for name in FIELDS:
        x, y = getattr(ta, name), getattr(tb, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert ta.root_id == tb.root_id and ta.M == tb.M and ta.K == tb.K


def _path_tree_codes(n=64, M=8, seed=5):
    """A pure path: node i differs from i-1 in one subspace."""
    rng = np.random.default_rng(seed)
    codes = np.empty((n, M), np.uint8)
    codes[0] = rng.integers(0, 256, size=M)
    for i in range(1, n):
        codes[i] = codes[i - 1]
        codes[i, rng.integers(0, M)] = rng.integers(0, 256)
    return codes


def test_mkk_tables_equal():
    cw = codebook(np.random.default_rng(1), 4, 32, 4)
    assert np.array_equal(player.mkk_tables(cw), jlayout.mkk_tables(cw))


@pytest.mark.parametrize("kind,M,K,child_order", [
    ("structured", 8, 256, "dist"), ("structured", 4, 32, "dist"),
    ("structured", 4, 32, "code"), ("chain", 8, 256, "dist"),
    ("structured", 12, 16, "dist")])
def test_table_layout_equal(kind, M, K, child_order):
    """build_layout with codewords: the ancestor walk's pruning bounds,
    the max_dist2p (or code) child order and the DFS equal JAX's."""
    codes = _codes(kind, M, K)
    cw = codebook(np.random.default_rng(M + K), M, K, 4)
    res = find_edges_by_diff(codes, K=K)
    ta = jlayout.build_layout(codes, res.edges, res.root_id, K=K,
                              codewords=cw, child_order=child_order)
    tb = player.build_layout(codes, res.edges, res.root_id, K=K,
                             codewords=cw, child_order=child_order)
    _assert_same_tree(ta, tb)
    assert tb.max_dist.any()              # the bounds are not the light zeros
    assert np.array_equal(tb.decode_codes(), codes)


@pytest.mark.parametrize("kind,M,K", [("structured", 8, 256),
                                      ("structured", 4, 32),
                                      ("chain", 8, 256),
                                      ("structured", 5, 16)])
def test_serialize_dtc_byte_equal(kind, M, K, tmp_path):
    codes = _codes(kind, M, K)
    cw = codebook(np.random.default_rng(7), M, K, 4)
    res = j_find(codes, K=K)
    ta = jlayout.build_layout(codes, res.edges, res.root_id, K=K,
                              codewords=cw)
    tb = player.build_layout(codes, res.edges, res.root_id, K=K,
                             codewords=cw)
    sa, sb = jser.serialize_dtc(ta), pser.serialize_dtc(tb)
    assert sa == sb
    # the file: written by the port, read by both packages
    path = str(tmp_path / "c.dtc")
    pser.write_dtc(path, tb)
    na, ra = jser.read_dtc_raw(path)
    nb, rb = pser.read_dtc_raw(path)
    assert na == nb == len(codes) and np.array_equal(ra, rb)
    assert ra.tobytes() == sa


@pytest.mark.parametrize("n", [2000, 2001])
def test_deserialize_and_decode_round_trip(n):
    """Even and odd node counts (the last record's own depth byte)."""
    codes = structured_codes(np.random.default_rng(n), n, 8, 256)
    res = find_edges_by_diff(codes, K=256)
    tree = player.build_layout(codes, res.edges, res.root_id, K=256,
                               tables="skip")
    stream = np.frombuffer(pser.serialize_dtc(tree), np.uint8)
    got = pser.deserialize_dtc(stream, n, 8)
    want = jser.deserialize_dtc(stream, n, 8, use_native=False)
    for x, y in zip(got, want):
        assert np.array_equal(x, y)
    dec = pser.decode_dtc_to_codes(stream, n, 8)
    assert np.array_equal(dec, jser.decode_dtc_to_codes(stream, n, 8,
                                                        use_native=False))
    assert np.array_equal(dec, codes[tree.vec_id.astype(np.int64)])


def test_reroot_min_height_equal():
    n = 41
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    oa, ra, ha = jreroot.reroot_min_height(edges, n)
    ob, rb, hb = preroot.reroot_min_height(edges, n)
    assert np.array_equal(oa, ob) and ra == rb and ha == hb == 20


def test_serialize_repairs_deep_tree():
    """A depth-63 path tree is repaired in place (center re-root + chain
    halving) by both packages to the same tree and the same bytes, and
    the stream still decodes losslessly."""
    n, M = 64, 8
    codes = _path_tree_codes(n, M)
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    tables = np.zeros((M, 256, 256), np.float32)
    ta = jlayout.build_layout(codes, edges, 0, K=256, tables=tables)
    tb = player.build_layout(codes, edges, 0, K=256, tables=tables)
    assert int(tb.depth.max()) == n - 1
    sa, sb = jser.serialize_dtc(ta), pser.serialize_dtc(tb)
    assert int(tb.depth.max()) <= 15
    _assert_same_tree(ta, tb)
    assert sa == sb
    dec = pser.decode_dtc_to_codes(np.frombuffer(sb, np.uint8), n, M)
    assert np.array_equal(dec[np.argsort(tb.vec_id.astype(np.int64))],
                          codes)
    with pytest.raises(ValueError):
        pser.serialize_dtc(player.build_layout(codes, edges, 0, K=256,
                                               tables=tables),
                           auto_repair=False)


def test_repair_tree_equal():
    codes = _path_tree_codes(48, 8, seed=9)
    edges = np.stack([np.arange(47), np.arange(1, 48)], axis=1)
    tables = np.zeros((8, 256, 256), np.float32)
    ta = jreroot.repair_tree(jlayout.build_layout(codes, edges, 0, K=256,
                                                  tables=tables))
    tb = preroot.repair_tree(player.build_layout(codes, edges, 0, K=256,
                                                 tables=tables))
    _assert_same_tree(ta, tb)
    assert int(tb.depth.max()) <= 15


def test_unsupported_formats_raise():
    codes = structured_codes(np.random.default_rng(2), 500, 12, 16)
    res = find_edges_by_diff(codes, K=16)
    tree = player.build_layout(codes, res.edges, res.root_id, K=16,
                               tables="skip")
    with pytest.raises(NotImplementedError):
        pser.serialize_dtc(tree)                  # M > 8: one-byte bitmap
