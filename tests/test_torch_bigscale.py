"""The port's big-N pipeline (``bigscale.py``), the stream tiles' on-disk
form and the dedup tier's int8 and chunked inner engines against the JAX
package, on the same NumPy inputs (Pallas in interpret mode on the JAX
side); every engine's distances bit-equal to the port's plain exact scan
``adc_query_topk``.

Three faults of the port against the JAX package are held here: the
dedup tier above ``EXACT_ALL_MAX_ROWS`` distinct codes at its int8
default, its chunked inner engine, and engine files with slot tiles
(with ``fmt`` and without it)."""

import warnings

import numpy as np
import pytest
import torch

from deltapq_tpu import bigscale as jbig
from deltapq_tpu.ops import fused as jfused
from deltapq_tpu.ops.encode import pq_encode as j_encode
from deltapq_tpu.ops.stream_tiles import StreamTiles as JStreamTiles
from deltapq_tpu_torch import bigscale as pbig
from deltapq_tpu_torch.convert import load_jax_engine
from deltapq_tpu_torch.index import DeltaPQIndex
from deltapq_tpu_torch.ops import fused as pfused
from deltapq_tpu_torch.ops.adc import adc_query_topk, adc_table, pad_codes
from deltapq_tpu_torch.ops.encode import pq_encode
from deltapq_tpu_torch.ops.stream_tiles import (StreamTiles,
                                                build_stream_tiles,
                                                decode_stream_tiles)

from _torch_port import (CPU, assert_ids_carry_dists, assert_ids_up_to_ties,
                         codebook, structured_codes)

M, K, Ds = 8, 16, 4
N, B, TOPK, CHUNK = 3000, 32, 10, 1024


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    cw = codebook(rng, M, K, Ds)
    codes = structured_codes(rng, N, M, K)
    rows = codes[rng.integers(0, N, B)]
    queries = (np.concatenate([cw[m][rows[:, m]] for m in range(M)], 1)
               + rng.normal(size=(B, M * Ds)).astype(np.float32))
    return dict(cw=cw, codes=codes, queries=queries)


def _table(data):
    return adc_table(torch.from_numpy(data["cw"]),
                     torch.from_numpy(data["queries"]))


def _check(data, d, i, jd=None, ji=None):
    """Distances bit-equal to the port's exact scan over the same table,
    ids carrying their distances; against JAX results (when given)
    rtol 1e-5, atol 1e-4 (table ulps between the frameworks' f32
    matmuls) and ids equal up to f64-audited ties."""
    codes, table = data["codes"], _table(data)
    dr, _ = adc_query_topk(table, torch.from_numpy(pad_codes(codes, 1024)),
                           N, TOPK, 1024)
    assert np.array_equal(d, dr.numpy())
    assert_ids_carry_dists(table.numpy(), codes, d, i)
    if jd is not None:
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)
        assert_ids_up_to_ties(table.numpy(), codes, i, np.asarray(ji),
                              TOPK)


@pytest.mark.parametrize("mmap", [False, True])
def test_stream_tiles_save_load_across_packages(data, tmp_path, mmap):
    codes = data["codes"][np.lexsort(data["codes"].T[::-1])]
    st = build_stream_tiles(codes)
    st.save(str(tmp_path / "port"))
    jt = JStreamTiles.load(str(tmp_path / "port"), mmap=mmap)
    jt.save(str(tmp_path / "jax"))
    back = StreamTiles.load(str(tmp_path / "jax"), mmap=mmap)
    for t in (jt, back):
        for name in ("row_data", "vals", "meta"):
            assert np.array_equal(getattr(t, name), getattr(st, name))
        assert (t.n_valid, t.M, t.e_max) == (st.n_valid, st.M, st.e_max)
    assert isinstance(back.vals, np.memmap) == mmap
    assert back.vals.flags.writeable != mmap
    assert np.array_equal(decode_stream_tiles(back), codes)
    # an engine over read-only mapped tiles copies them before the
    # upload: no non-writable-array warning from torch
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = pfused.FusedCompressedEngine.from_tiles(data["cw"], back,
                                                      precision="int8",
                                                      device=CPU)
    assert torch.equal(eng.vals, torch.from_numpy(st.vals))


def test_encode_stream_matches_jax(data):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2500, M * Ds)).astype(np.float32) * 3
    chunks = [x[i:i + 700] for i in range(0, len(x), 700)]
    got = pbig.encode_stream(torch.from_numpy(data["cw"]), iter(chunks))
    assert got.dtype == np.uint8 and got.shape == (len(x), M)
    # chunk by chunk equals one call
    assert np.array_equal(
        got, pq_encode(torch.from_numpy(data["cw"]), x).numpy())
    want = jbig.encode_stream(data["cw"], iter(chunks))
    # argmin ties between the frameworks' f32 distances (as in
    # tests/test_torch_pq.py)
    assert (got != want).any(axis=1).mean() < 1e-3
    assert np.array_equal(want, j_encode(data["cw"], x))


@pytest.mark.parametrize("workers", [1, 2])
def test_build_partitioned_matches_jax(data, workers):
    codes = data["codes"]
    row_to_db, stats = pbig.build_partitioned(codes, n_parts=3, K=K,
                                              workers=workers)
    jrow, jstats = jbig.build_partitioned(codes, n_parts=3, K=K,
                                          workers=1)
    assert np.array_equal(row_to_db, jrow)
    assert sorted(row_to_db.tolist()) == list(range(N))
    assert (stats.n, stats.n_parts, stats.n_diffs) == (
        jstats.n, jstats.n_parts, jstats.n_diffs)
    assert len(stats.per_part) == 3 and stats.t_build >= 0.0


@pytest.mark.parametrize("chunk_rows", [None, CHUNK])
def test_big_index_matches_jax(data, chunk_rows):
    """Small N: one compressed engine; ``chunk_rows=1024``: three
    resident chunks.  Both at the int8 default."""
    cw, codes = data["cw"], data["codes"]
    idx = pbig.BigCompressedIndex(cw, codes, n_parts=2, workers=1,
                                  chunk_rows=chunk_rows, device=CPU)
    jidx = jbig.BigCompressedIndex(cw, codes, n_parts=2, workers=1,
                                   chunk_rows=chunk_rows)
    assert np.array_equal(idx.row_to_db, jidx.row_to_db)
    chunked = chunk_rows is not None
    assert isinstance(idx.engine, pbig.ChunkedCompressedEngine) == chunked
    assert idx.bytes_per_vec() == pytest.approx(jidx.bytes_per_vec())
    idx.warmup(batch_sizes=(B,), top_k=TOPK)
    d, i = idx.query(data["queries"], top_k=TOPK)
    jd, ji = jidx.query(data["queries"], top_k=TOPK)
    _check(data, d, i, jd, ji)
    if chunked:
        assert len(idx.engine.last_exact_fracs) == 3
        assert idx.engine.last_upload_s == 0.0


@pytest.mark.parametrize("resident", [True, False])
def test_chunked_engine_matches_jax(data, resident):
    cw, codes = data["cw"], data["codes"]
    order = np.lexsort(codes.T[::-1])
    eng = pbig.ChunkedCompressedEngine(cw, codes[order], row_to_db=order,
                                       chunk_rows=CHUNK, resident=resident,
                                       device=CPU)
    jeng = jbig.ChunkedCompressedEngine(cw, codes[order], row_to_db=order,
                                        chunk_rows=CHUNK, resident=resident)
    assert (len(eng.chunks) if resident else len(eng._host)) == 3
    assert eng.bytes_per_vec() == pytest.approx(jeng.bytes_per_vec())
    eng.warmup(batch_sizes=(B,), top_k=TOPK)
    d, i = eng.query(data["queries"], top_k=TOPK)
    jd, ji = jeng.query(data["queries"], top_k=TOPK)
    _check(data, d, i, jd, ji)
    assert len(eng.last_exact_fracs) == 3
    assert all(0.0 <= f <= 1.0 for f in eng.last_exact_fracs)
    assert (eng.last_upload_s > 0.0) != resident


def test_chunked_from_saved_mmap_across_packages(data, tmp_path):
    """Port save -> port and JAX ``from_saved(mmap=True)``; JAX save ->
    port ``from_saved``, resident and not."""
    cw, codes = data["cw"], data["codes"]
    order = np.lexsort(codes.T[::-1])
    eng = pbig.ChunkedCompressedEngine(cw, codes[order], row_to_db=order,
                                       chunk_rows=CHUNK, device=CPU)
    d0, i0 = eng.query(data["queries"], top_k=TOPK)
    _check(data, d0, i0)
    eng.save(str(tmp_path / "port"))
    back = pbig.ChunkedCompressedEngine.from_saved(str(tmp_path / "port"),
                                                   mmap=True, device=CPU)
    assert not back.resident and back.precision == "int8"
    assert isinstance(back._host[0][0].vals, np.memmap)
    d, i = back.query(data["queries"], top_k=TOPK)
    assert np.array_equal(d, d0) and np.array_equal(i, i0)
    jback = jbig.ChunkedCompressedEngine.from_saved(str(tmp_path / "port"),
                                                    mmap=True)
    jd, ji = jback.query(data["queries"], top_k=TOPK)
    _check(data, d, i, jd, ji)
    jback.save(str(tmp_path / "jax"))
    for resident in (True, False):
        b2 = pbig.ChunkedCompressedEngine.from_saved(
            str(tmp_path / "jax"), mmap=True, resident=resident, device=CPU)
        d2, i2 = b2.query(data["queries"], top_k=TOPK)
        assert np.array_equal(d2, d0) and np.array_equal(i2, i0)
    # the mesh form reopens the same directory, exact at its precision
    from deltapq_tpu_torch.parallel import make_mesh

    b3 = pbig.ChunkedCompressedEngine.from_saved(
        str(tmp_path / "jax"), mmap=True, mesh=make_mesh(2, device=CPU))
    assert all(c.precision == "int8" for c in b3.chunks)
    d3, i3 = b3.query(data["queries"], top_k=TOPK)
    assert np.array_equal(d3, d0)
    _check(data, d3, i3)


def test_dedup_int8_inner_engine_above_exact_all(data, monkeypatch):
    """Fault 1: the dedup tier at its defaults over more than
    ``EXACT_ALL_MAX_ROWS`` distinct codes (lowered here) builds its int8
    inner engine, directly and through ``DeltaPQIndex``."""
    cw, codes = data["cw"], data["codes"]
    for cls in (pfused.DedupCompressedEngine, jfused.DedupCompressedEngine):
        monkeypatch.setattr(cls, "EXACT_ALL_MAX_ROWS", 100)
    eng = pfused.DedupCompressedEngine(cw, codes, device=CPU)
    jeng = jfused.DedupCompressedEngine(cw, codes)
    assert eng.n_unique == jeng.n_unique > 100
    assert isinstance(eng.engine, pfused.FusedCompressedEngine)
    assert eng.engine.precision == "int8"
    assert eng.bytes_per_vec() == pytest.approx(jeng.bytes_per_vec())
    d, i = eng.query(data["queries"], top_k=TOPK)
    jd, ji = jeng.query(data["queries"], top_k=TOPK)
    _check(data, d, i, jd, ji)
    idx = DeltaPQIndex(cw, codes, engine="fused_dedup", build_tree=False,
                       device=CPU)
    d2, i2 = idx.search(data["queries"], top_k=TOPK)
    assert idx._fused_engine.engine.precision == "int8"
    assert np.array_equal(d2, d) and np.array_equal(i2, i)


def test_dedup_chunked_inner_engine(data, monkeypatch):
    """Fault 2: above ``chunked_min_rows`` distinct codes the inner
    engine is a ``ChunkedCompressedEngine``, as in the JAX package."""
    cw, codes = data["cw"], data["codes"]
    for cls in (pfused.DedupCompressedEngine, jfused.DedupCompressedEngine):
        monkeypatch.setattr(cls, "EXACT_ALL_MAX_ROWS", 100)
    eng = pfused.DedupCompressedEngine(cw, codes, chunked_min_rows=500,
                                       device=CPU)
    jeng = jfused.DedupCompressedEngine(cw, codes, chunked_min_rows=500)
    assert isinstance(eng.engine, pbig.ChunkedCompressedEngine)
    assert isinstance(jeng.engine, jbig.ChunkedCompressedEngine)
    assert eng.engine.precision == "int8" and eng.engine.resident
    assert eng.bytes_per_vec() == pytest.approx(jeng.bytes_per_vec())
    d, i = eng.query(data["queries"], top_k=TOPK)
    jd, ji = jeng.query(data["queries"], top_k=TOPK)
    _check(data, d, i, jd, ji)


@pytest.mark.parametrize("with_fmt", [True, False])
def test_jax_slot_file_loads(data, tmp_path, with_fmt):
    """Fault 3: a JAX-saved slot-tile engine, with ``fmt`` and without it
    (the files of the first format have none), loads through
    ``convert.load_jax_engine`` and answers as the JAX engine does."""
    cw, codes = data["cw"], data["codes"]
    order = np.lexsort(codes.T[::-1])
    jeng = jfused.FusedCompressedEngine(cw, codes[order], row_to_db=order,
                                        precision="int16", fmt="slots")
    path = str(tmp_path / "slots.npz")
    jeng.save(path)
    if not with_fmt:
        with np.load(path) as z:
            state = {k: z[k] for k in z.files if k != "fmt"}
        np.savez(path, **state)
    peng = load_jax_engine(path, device=CPU)
    assert peng.fmt == "slots" and peng.precision == "int16"
    for name in ("row_data", "ovf"):
        assert np.array_equal(getattr(peng.tiles, name),
                              getattr(jeng.tiles, name))
    assert (peng.tiles.S, peng.tiles.Cap) == (jeng.tiles.S, jeng.tiles.Cap)
    d, i = peng.query(data["queries"], top_k=TOPK)
    jd, ji = jeng.query(data["queries"], top_k=TOPK)
    _check(data, d, i, jd, ji)
    # the port's own slot file keeps its precision and format
    peng.save(str(tmp_path / "port_slots"))
    back = pfused.FusedCompressedEngine.load(str(tmp_path / "port_slots"),
                                             device=CPU)
    assert back.fmt == "slots" and back.precision == "int16"
    d2, i2 = back.query(data["queries"], top_k=TOPK)
    assert np.array_equal(d2, d) and np.array_equal(i2, i)
