"""The port's DeltaPQIndex against the JAX package's: the cases of
tests/test_index.py on the same codewords and codes, every engine by
name, the save/load layout in both directions and the port's own
``auto`` rule."""

import numpy as np
import pytest
import torch

from deltapq_tpu.index import DeltaPQIndex as JIndex
from deltapq_tpu_torch.convert import load_jax_index
from deltapq_tpu_torch.index import DeltaPQIndex
from deltapq_tpu_torch.ops.adc import adc_query_topk, adc_table, pad_codes
from deltapq_tpu_torch.ops.fused import DedupCompressedEngine

from _torch_port import CPU, assert_ids_carry_dists, assert_ids_up_to_ties

ENGINES = ("xla", "pallas", "fused", "fused_codes", "fused_compressed",
           "fused_dedup")
TREE_FIELDS = ("vec_id", "parent_pos", "depth", "diff_num", "diff_off",
               "diff_m", "diff_to", "child_pos_start", "child_num",
               "max_dist", "max_dist2p")


@pytest.fixture(scope="module")
def built(small_dataset):
    """The JAX index built on the shared dataset; both packages then index
    its codewords and codes."""
    return JIndex.build(small_dataset[:1000], small_dataset, M=4, K=16,
                        max_iters=15)


def _pair(built, **kw):
    return (JIndex(built.codewords, built.codes.copy(), **kw),
            DeltaPQIndex(built.codewords, built.codes.copy(), **kw,
                         device=CPU))


def _table(idx, q):
    return adc_table(torch.from_numpy(idx.codewords),
                     torch.from_numpy(np.asarray(q, np.float32)))


def _check_search(jidx, pidx, q, top_k):
    """Distances against JAX's (rtol 1e-5, atol 1e-4: table ulps between
    the frameworks), ids up to ties; bit-equal to the port's exact scan
    over the live rows."""
    jd, ji = jidx.search(q, top_k=top_k)
    d, i = pidx.search(q, top_k=top_k)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)
    codes = pidx._all_codes()
    table = _table(pidx, q).numpy()
    live = np.isfinite(d)
    assert_ids_carry_dists(table, codes, np.where(live, d, 0),
                           np.where(live, i, 0))
    if not pidx.deleted.any():
        assert_ids_up_to_ties(table, codes, i, np.asarray(ji), top_k)
        k = min(top_k, len(codes))
        dr, _ = adc_query_topk(torch.from_numpy(table),
                               torch.from_numpy(pad_codes(codes, 1024)),
                               len(codes), k, 1024)
        assert np.array_equal(d[:, :k], dr.numpy())
    return d, i


def test_build_and_search(built, small_dataset):
    jidx, idx = _pair(built)
    for name in TREE_FIELDS:
        assert np.array_equal(getattr(idx.tree, name),
                              getattr(jidx.tree, name)), name
    assert idx._stream == jidx._stream
    d, i = _check_search(jidx, idx, small_dataset[:8], 5)
    for b in range(8):                      # self-query: own code first
        np.testing.assert_array_equal(idx.codes[i[b, 0]], idx.codes[b])
    st = idx.stats()
    assert st == jidx.stats()
    assert st["compressed_bytes"] < st["plain_bytes"]


def test_build_from_vectors(small_dataset):
    """``build`` learns with a torch.Generator: another codebook than
    JAX's, the same pipeline."""
    idx = DeltaPQIndex.build(small_dataset[:1000], small_dataset, M=4,
                             K=16, max_iters=15, seed=3, device=CPU)
    assert idx.codes.shape == (len(small_dataset), 4)
    d, i = idx.search(small_dataset[:8], top_k=5)
    for b in range(8):
        np.testing.assert_array_equal(idx.codes[i[b, 0]], idx.codes[b])


def test_add_and_search(built, small_dataset):
    jidx, idx = _pair(built)
    new = small_dataset[:3] + 0.01
    ids = idx.add(new)
    assert list(ids) == list(jidx.add(new)) == [2000, 2001, 2002]
    assert np.array_equal(idx.tail, jidx.tail)
    d, i = _check_search(jidx, idx, new, 2)
    all_codes = idx._all_codes()
    for b in range(3):
        np.testing.assert_array_equal(all_codes[i[b, 0]],
                                      all_codes[2000 + b])


def test_remove_masks_results(built, small_dataset):
    jidx, idx = _pair(built)
    q = small_dataset[:4]
    d0, i0 = idx.search(q, top_k=3)
    idx.remove(i0[:, 0])
    jidx.remove(i0[:, 0])
    d1, i1 = _check_search(jidx, idx, q, 3)
    for b in range(4):
        assert i0[b, 0] not in i1[b]


def test_rebuild_threshold_compacts(built, small_dataset):
    jidx, idx = _pair(built, rebuild_fraction=0.01)
    idx.add(small_dataset[:50])
    jidx.add(small_dataset[:50])
    assert len(idx.tail) == 0 and len(idx.codes) == 2050
    assert idx.tree is not None and idx.tree.n == 2050
    assert idx._stream == jidx._stream


def test_compact_drops_deleted(built):
    jidx, idx = _pair(built)
    idx.remove([0, 1, 2])
    jidx.remove([0, 1, 2])
    idx.compact()
    jidx.compact()
    assert len(idx.codes) == 1997 and not idx.deleted.any()
    assert np.array_equal(idx.codes, jidx.codes)
    assert idx._stream == jidx._stream


def test_search_topk_exceeds_n(built):
    idx = DeltaPQIndex(built.codewords, built.codes[:7].copy(),
                       build_tree=False, device=CPU)
    q = np.random.default_rng(0).normal(size=(3, 32)).astype(np.float32)
    d, i = idx.search(q, top_k=12)
    assert d.shape == (3, 12) and i.shape == (3, 12)
    assert np.isinf(d[:, 7:]).all() and (i[:, 7:] == -1).all()
    assert (i[:, :7] >= 0).all()
    jd, _ = JIndex(built.codewords, built.codes[:7].copy(),
                   build_tree=False).search(q, top_k=12)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("engine", ["xla", "fused_compressed"])
def test_search_mass_delete(built, small_dataset, engine):
    idx = DeltaPQIndex(built.codewords, built.codes.copy(), engine=engine,
                       build_tree=engine != "xla", device=CPU)
    keep = [5, 123]
    idx.remove([j for j in range(idx.n) if j not in keep])
    d, i = idx.search(small_dataset[:4], top_k=10)
    live = np.isfinite(d)
    assert set(i[live].ravel()) <= set(keep)
    assert (i[~live] == -1).all()


@pytest.mark.parametrize("engine", ENGINES)
def test_every_engine_by_name(built, small_dataset, engine):
    """Each engine through the facade: against the JAX index's plain
    search, and bit-equal to the port's exact scan."""
    jidx = JIndex(built.codewords, built.codes.copy(), engine="xla")
    idx = DeltaPQIndex(built.codewords, built.codes.copy(), engine=engine,
                       device=CPU)
    _check_search(jidx, idx, small_dataset[:8] + 0.01, 5)
    if engine == "fused_compressed":
        assert idx._fused_engine.precision == "bf16"   # as the JAX index


def test_fused_search_with_deletes(built, small_dataset):
    idx = DeltaPQIndex(built.codewords, built.codes.copy(), engine="fused",
                       device=CPU)
    q = small_dataset[:4]
    d0, i0 = idx.search(q, top_k=10)
    idx.remove(i0[0, :5][i0[0, :5] >= 0])
    d, i = idx.search(q, top_k=10)
    assert np.isfinite(d[0]).sum() == 10
    assert not np.isin(i0[0, :5], i[0]).any()


def test_index_m16_compressed_matches_jax(rng):
    """M=16: the tree builds and there is no DTC stream, as in the JAX
    package; the compressed tier (two mask planes, two subspace groups)
    serves the index as every other tier does, and nothing raises any
    more.  ``stats()`` is the JAX index's."""
    M, K, Ds, n = 16, 16, 4, 600
    x = rng.normal(size=(n, M * Ds)).astype(np.float32)
    jidx = JIndex.build(x, x, M=M, K=K, max_iters=10)
    idx = DeltaPQIndex(jidx.codewords, jidx.codes,
                       engine="fused_compressed", device=CPU)
    assert idx.tree is not None and idx._stream is None
    jc = JIndex(jidx.codewords, jidx.codes, engine="fused_compressed")
    for top_k in (5, 100):
        _check_search(jc, idx, x[:8] + 0.01, top_k)
    eng = idx._fused_engine
    assert eng.precision == "bf16" and eng.row_data.shape[1] == 2
    assert np.array_equal(eng.tiles.row_data, jc._fused_engine.tiles.row_data)
    assert idx.stats() == jc.stats()
    assert "bytes_per_vec" not in idx.stats()
    assert "delta_tile_bytes_per_vec" in idx.stats()
    jidx.engine = "xla"
    for engine in ("pallas", "fused", "fused_codes", "fused_dedup"):
        idx = DeltaPQIndex(jidx.codewords, jidx.codes, engine=engine,
                           device=CPU)
        _check_search(jidx, idx, x[:8] + 0.01, 5)
    # on a card "auto" picks the compressed tier for these codes
    assert idx._resolve_auto("cuda") == "fused_dedup"     # 600 rows
    from deltapq_tpu_torch.ops.fused import DedupCompressedEngine as D
    old = D.EXACT_ALL_MAX_ROWS
    try:
        D.EXACT_ALL_MAX_ROWS = 10
        assert idx._resolve_auto("cuda") == "fused_compressed"
    finally:
        D.EXACT_ALL_MAX_ROWS = old


def test_index_fused_dedup_engine(built, small_dataset):
    jidx, idx = _pair(built, engine="fused_dedup")
    _check_search(jidx, idx, small_dataset[:8] + 0.01, 5)
    assert isinstance(idx._fused_engine, DedupCompressedEngine)


def test_save_in_jax_load_in_port(built, small_dataset, tmp_path):
    jidx = JIndex(built.codewords, built.codes.copy(), engine="fused")
    jidx.remove([4, 9])
    path = str(tmp_path / "jax_idx")
    jidx.save(path)
    idx = load_jax_index(path, device="cpu")
    assert idx.engine == "fused" and idx.n == 1998
    for name in TREE_FIELDS:
        assert np.array_equal(getattr(idx.tree, name),
                              getattr(jidx.tree, name)), name
    _check_search(JIndex.load(path), idx, small_dataset[:6], 5)


def test_save_in_port_load_in_jax(built, small_dataset, tmp_path):
    idx = DeltaPQIndex(built.codewords, built.codes.copy(),
                       engine="fused_codes", device=CPU)
    idx.add(small_dataset[:5] + 0.02)
    path = str(tmp_path / "port_idx")
    idx.save(path)                             # folds the tail in
    jidx = JIndex.load(path)
    assert jidx.engine == "fused_codes" and jidx.n == 2005
    assert np.array_equal(jidx.codes, idx.codes)
    for name in TREE_FIELDS:
        assert np.array_equal(getattr(jidx.tree, name),
                              getattr(idx.tree, name)), name
    back = DeltaPQIndex.load(path, device=CPU)
    _check_search(jidx, back, small_dataset[:6], 5)


def test_resolve_auto(built, monkeypatch):
    """The port's rule: the JAX accelerator branch on a CUDA device, the
    plain scan on the CPU; "auto" on CUDA never resolves to "xla"."""
    idx = DeltaPQIndex(built.codewords, built.codes.copy(),
                       build_tree=False, device=CPU)
    assert idx._resolve_auto("cpu") == "xla"
    assert idx._resolve_auto() == "xla"            # the index is on cpu
    assert idx._resolve_auto("cuda") == "fused_dedup"
    monkeypatch.setattr(DedupCompressedEngine, "EXACT_ALL_MAX_ROWS", 10)
    assert idx._resolve_auto("cuda") == "fused_compressed"
    rng = np.random.default_rng(1)
    wide = DeltaPQIndex(rng.normal(size=(2, 512, 4)).astype(np.float32),
                        rng.integers(0, 512, (100, 2)).astype(np.int32),
                        device=CPU)
    assert wide._resolve_auto("cuda") == "pallas"
    assert wide._resolve_auto("cpu") == "xla"
    empty = DeltaPQIndex(built.codewords, built.codes[:0].copy(), device=CPU)
    assert empty._resolve_auto("cuda") == "pallas"


def test_wide_codes_take_the_decoded_tier(rng):
    """K > 256 (int32 codes): the fused engines upgrade to the decoded
    tier, as in the JAX index, and "pallas" scans int32 codes."""
    M, K, Ds = 2, 512, 4
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    codes = rng.integers(0, K, (3000, M)).astype(np.int32)
    q = rng.normal(size=(6, M * Ds)).astype(np.float32)
    jidx = JIndex(cw, codes, engine="xla")
    for engine in ("fused_codes", "pallas", "fused"):
        idx = DeltaPQIndex(cw, codes, engine=engine, device=CPU)
        _check_search(jidx, idx, q, 5)
