"""The rest of the port's tree package against the JAX package's, on
the same NumPy inputs: the exact-MST edges, ``tree_height``,
``rotate_tree``, ``block_aware_size``, the legacy bit format and the
row-store format byte for byte, and their query functions (the port's
scan on the CPU) within rtol 1e-5, atol 1e-4, ids up to f64-audited
ties."""

import copy

import numpy as np
import pytest
import torch

from deltapq_tpu.tree import exact_mst as jmst
from deltapq_tpu.tree.build import find_edges_by_diff as j_find
from deltapq_tpu.tree import layout as jlayout
from deltapq_tpu.tree import reroot as jreroot
from deltapq_tpu.tree import serialize as jser
from deltapq_tpu_torch.ops.adc import adc_table, query_plain
from deltapq_tpu_torch.tree import exact_mst as pmst
from deltapq_tpu_torch.tree import layout as player
from deltapq_tpu_torch.tree import reroot as preroot
from deltapq_tpu_torch.tree import serialize as pser
from deltapq_tpu_torch.tree.build import find_edges_by_diff

from _torch_port import CPU, assert_ids_up_to_ties, codebook, structured_codes

N = 1500
CASES = [(M, K) for M in (4, 8) for K in (16, 256)]
IDS = [f"m{M}k{K}" for M, K in CASES]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    M, K = request.param
    codes = structured_codes(np.random.default_rng(M * K), N, M, K)
    res = pmst.find_edges_exact_mst(codes, K)
    jres = jmst.find_edges_exact_mst(codes, K)
    tree = player.build_layout(codes, res.edges, res.root_id, K=K,
                               tables="skip")
    jtree = jlayout.build_layout(codes, jres.edges, jres.root_id, K=K,
                                 tables="skip")
    # the bit format's 3-bit depth field takes the approximate tree's
    # bounded height (<= 7), not the exact-MST tree's
    ares, jares = find_edges_by_diff(codes, K=K), j_find(codes, K=K)
    atree = player.build_layout(codes, ares.edges, ares.root_id, K=K,
                                tables="skip")
    jatree = jlayout.build_layout(codes, jares.edges, jares.root_id, K=K,
                                  tables="skip")
    assert int(atree.depth.max()) <= 7
    return dict(M=M, K=K, codes=codes, res=res, jres=jres, tree=tree,
                jtree=jtree, atree=atree, jatree=jatree)


def test_exact_mst_equal(case):
    res, jres = case["res"], case["jres"]
    assert res.edges.dtype == jres.edges.dtype
    assert np.array_equal(res.edges, jres.edges)
    assert res.root_id == jres.root_id and res.n_diffs == jres.n_diffs
    assert len(res.edges) == N - 1                    # spanning
    assert np.array_equal(res.heights, jres.heights)
    assert np.array_equal(res.finalists, jres.finalists)


def test_union_find_equal():
    rng = np.random.default_rng(4)
    p, j = pmst._UnionFind(200), jmst._UnionFind(200)
    for a, b in rng.integers(0, 200, size=(300, 2)):
        assert p.union(int(a), int(b)) == j.union(int(a), int(b))
    ids = rng.integers(0, 200, 50)
    assert np.array_equal(p.find_many(ids), j.find_many(ids))
    assert np.array_equal(p.parent, j.parent)


def test_tree_height_and_rotate_equal(case):
    res = case["res"]
    h = preroot.tree_height(res.edges, res.root_id, N)
    assert h == jreroot.tree_height(res.edges, res.root_id, N)
    out = preroot.rotate_tree(res.edges, res.root_id, N)
    jout = jreroot.rotate_tree(res.edges, res.root_id, N)
    assert out[0].dtype == jout[0].dtype
    assert np.array_equal(out[0], jout[0])
    assert out[1:] == jout[1:]
    assert out[2] <= h
    assert preroot.tree_height(out[0], out[1], N) == out[2]


def test_rotate_tree_on_a_path():
    """A path rooted at one end: the rotation walks to its middle."""
    edges = np.stack([np.arange(99), np.arange(1, 100)], 1)
    out = preroot.rotate_tree(edges, 0, 100)
    jout = jreroot.rotate_tree(edges, 0, 100)
    assert np.array_equal(out[0], jout[0]) and out[1:] == jout[1:]
    assert out[2] in (49, 50)


def test_block_aware_size_equal(case):
    for bb in (512, 4096):
        assert (pser.block_aware_size(case["tree"], bb)
                == jser.block_aware_size(case["jtree"], bb))


def test_bit_format_equal(case):
    tree, M = case["atree"], case["M"]
    stream, n_bits = pser.serialize_bits(tree)
    assert (stream, n_bits) == jser.serialize_bits(case["jatree"])
    codes = pser.deserialize_bits(stream, n_bits, N, M)
    assert np.array_equal(codes, jser.deserialize_bits(stream, n_bits, N, M))
    assert np.array_equal(codes, case["codes"][tree.vec_id.astype(np.int64)])


def test_bit_format_refuses_m_above_8():
    codes = structured_codes(np.random.default_rng(2), 200, 12, 16)
    res = pmst.find_edges_exact_mst(codes, 16)
    tree = player.build_layout(codes, res.edges, res.root_id, K=16,
                               tables="skip")
    with pytest.raises(NotImplementedError):
        pser.serialize_bits(tree)


def test_row_store_equal(case):
    M = case["M"]
    raw = np.random.default_rng(5).integers(0, 256, (N, 24)).astype(np.uint8)
    tree, jtree = copy.deepcopy(case["tree"]), copy.deepcopy(case["jtree"])
    stream = pser.serialize_dtc_row_store(tree, raw)
    assert stream == jser.serialize_dtc_row_store(jtree, raw)
    assert int(tree.depth.max()) <= 15      # repaired, as serialize_dtc does
    assert np.array_equal(tree.vec_id, jtree.vec_id)
    codes, rows = pser.deserialize_dtc_row_store(stream, N, M, 24)
    jcodes, jrows = jser.deserialize_dtc_row_store(stream, N, M, 24)
    assert np.array_equal(codes, jcodes) and np.array_equal(rows, jrows)
    vid = tree.vec_id.astype(np.int64)
    assert np.array_equal(codes, case["codes"][vid])
    assert np.array_equal(rows, raw[vid])


def _queries(case, b=16):
    rng = np.random.default_rng(11)
    cw = codebook(rng, case["M"], case["K"], 4)
    rows = case["codes"][rng.integers(0, N, b)]
    q = (np.concatenate([cw[m][rows[:, m]] for m in range(case["M"])], 1)
         + rng.normal(size=(b, case["M"] * 4)).astype(np.float32))
    table = adc_table(torch.from_numpy(cw), torch.from_numpy(q)).numpy()
    return cw, q, table


def test_query_bits_equal(case):
    tree, M = case["atree"], case["M"]
    cw, q, table = _queries(case)
    stream, n_bits = pser.serialize_bits(tree)
    d, ids = pser.query_bits(stream, n_bits, N, M, cw, q, tree.vec_id,
                             top_k=10, device=CPU)
    jd, jids = jser.query_bits(stream, n_bits, N, M, cw, q, tree.vec_id,
                               top_k=10)
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5, atol=1e-4)
    ed, _ = query_plain(cw, q, case["codes"], top_k=10, engine="xla",
                        device=CPU)
    assert np.array_equal(d, ed)
    assert_ids_up_to_ties(table, case["codes"], ids, np.asarray(jids), 10)


def test_query_row_store_equal(case):
    M = case["M"]
    tree = copy.deepcopy(case["tree"])
    cw, q, table = _queries(case)
    raw = np.random.default_rng(6).integers(0, 256, (N, 32)).astype(np.uint8)
    stream = pser.serialize_dtc_row_store(tree, raw)
    d, ids, rows = pser.query_row_store(stream, N, M, 32, cw, q,
                                        tree.vec_id, top_k=10, device=CPU)
    jd, jids, jrows = jser.query_row_store(stream, N, M, 32, cw, q,
                                           tree.vec_id, top_k=10)
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5, atol=1e-4)
    assert_ids_up_to_ties(table, case["codes"], ids, np.asarray(jids), 10)
    assert np.array_equal(rows, raw[ids])
    same = (ids == np.asarray(jids))
    assert np.array_equal(rows[same], np.asarray(jrows)[same])


def test_decoders_take_use_native(case):
    """``use_native`` as in the JAX signature: both settings give the
    JAX bytes."""
    tree = copy.deepcopy(case["tree"])
    stream = np.frombuffer(pser.serialize_dtc(tree), np.uint8)
    for un in (True, False):
        a = pser.deserialize_dtc(stream, N, case["M"], use_native=un)
        b = jser.deserialize_dtc(stream, N, case["M"], use_native=un)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert np.array_equal(
            pser.decode_dtc_to_codes(stream, N, case["M"], use_native=un),
            jser.decode_dtc_to_codes(stream, N, case["M"], use_native=un))


def test_tree_package_exports_equal():
    import deltapq_tpu.tree as jt
    import deltapq_tpu_torch.tree as pt
    assert sorted(pt.__all__) == sorted(jt.__all__)
    assert all(hasattr(pt, n) for n in pt.__all__)


def test_tree_taller_than_255_round_trips():
    """A 400-node path: the u8 depth wraps, yet ``decode_codes`` (from
    the parent pointers) is lossless, and so is ``serialize_dtc``'s
    repair through the DTC."""
    rng = np.random.default_rng(8)
    n = 400
    codes = np.empty((n, 8), np.uint8)
    codes[0] = rng.integers(0, 256, 8)
    for i in range(1, n):
        codes[i] = codes[i - 1]
        codes[i, rng.integers(0, 8)] = rng.integers(0, 256)
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    tree = player.build_layout(codes, edges, 0, K=256, tables="skip")
    assert np.array_equal(player._depths(tree.parent_pos), np.arange(n))
    assert np.array_equal(tree.decode_codes(), codes)
    stream = np.frombuffer(pser.serialize_dtc(tree), np.uint8)
    assert int(tree.depth.max()) <= 15
    assert np.array_equal(pser.decode_dtc_to_codes(stream, n, 8),
                          codes[tree.vec_id.astype(np.int64)])


def test_subtree_bounds_of_a_tree_taller_than_255():
    """``child_num`` counts each DFS subtree from the exact depths: a
    300-node spine with a leaf hung off every third node (height 299,
    above the u8 depth's 255), against sizes counted from the parent
    pointers; on a shorter tree it equals the JAX ``build_layout``'s."""
    rng = np.random.default_rng(9)
    spine, n = 300, 400
    parents = np.concatenate([np.arange(spine - 1),
                              np.arange(0, spine, 3)[:n - spine]])
    edges = np.stack([parents, np.arange(1, n)], 1)
    codes = rng.integers(0, 16, (n, 4)).astype(np.uint8)
    tree = player.build_layout(codes, edges, 0, K=16, tables="skip")
    pos = tree.parent_pos.astype(np.int64)
    size = np.ones(n, np.int64)
    for i in range(n - 1, 0, -1):          # a parent precedes its child
        size[pos[i]] += size[i]
    assert int(player._depths(pos).max()) == spine - 1
    assert np.array_equal(tree.child_num, size - 1)
    assert np.array_equal(tree.child_pos_start, np.arange(1, n + 1))
    short = edges[edges[:, 1] < 200]
    assert np.array_equal(
        player.build_layout(codes[:200], short, 0, K=16,
                            tables="skip").child_num,
        jlayout.build_layout(codes[:200], short, 0, K=16,
                             tables="skip").child_num)
