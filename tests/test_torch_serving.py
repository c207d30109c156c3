"""The port's wave-coalescing server (``deltapq_tpu_torch/serving.py``):
the cases of ``tests/test_serving.py`` over the port's engines on the
CPU, and the port's server over a port engine against the JAX server
over the JAX engine on the same waves (Pallas in interpret mode)."""

import threading

import numpy as np
import pytest
import torch

from deltapq_tpu.ops.fused import FusedCodesEngine as JFusedCodesEngine
from deltapq_tpu.serving import CoalescingServer as JServer
from deltapq_tpu_torch.ops.adc import adc_table
from deltapq_tpu_torch.ops.fused import (DedupCompressedEngine,
                                         FusedCodesEngine,
                                         FusedCompressedEngine)
from deltapq_tpu_torch.serving import CoalescingServer, query_coalesced

from _torch_port import (CPU, assert_ids_up_to_ties, codebook,
                         structured_codes)

M, K, DS = 4, 16, 8


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(3)
    cw = codebook(rng, M, K, DS)
    codes = structured_codes(rng, 4096, M, K)
    qs = rng.normal(size=(48, M * DS)).astype(np.float32) * 3 + 1
    return cw, codes, qs, FusedCodesEngine(cw, codes, device=CPU)


def _same(eng, q, d, ids, top_k, cw, codes):
    """(d, ids) as ``eng.query(q)`` gives them: distances bit-equal,
    ids up to f64-audited ties (the engine's ladder may take another
    rung for a row in another batch)."""
    dr, idr = eng.query(q, top_k=top_k)
    assert np.array_equal(d, dr)
    table = adc_table(torch.from_numpy(cw), torch.from_numpy(q)).numpy()
    assert_ids_up_to_ties(table, codes, ids, idr, top_k)


def test_query_coalesced_matches_individual(small):
    cw, codes, qs, eng = small
    batches = [qs[:7], qs[7:20], qs[20:21], qs[21:48]]
    got = query_coalesced(eng, batches, top_k=5, wave_rows=24)
    assert len(got) == len(batches)
    for b, (d, ids) in zip(batches, got):
        assert d.shape == (len(b), 5)
        _same(eng, b, d, ids, 5, cw, codes)


def test_server_coalesces_and_matches(small):
    cw, codes, qs, eng = small

    class Counting:
        def __init__(self, e):
            self.e, self.calls, self.sizes = e, 0, []

        def query(self, q, top_k):
            self.calls += 1
            self.sizes.append(len(q))
            return self.e.query(q, top_k=top_k)

    ce = Counting(eng)
    with CoalescingServer(ce, wave_rows=32, max_wait_ms=5000,
                          top_k=5) as srv:
        futs = [srv.submit(qs[i:i + 8]) for i in range(0, 48, 8)]
        outs = [f.result(timeout=30) for f in futs]
    # 6 waves of 8 rows -> at most 2 dispatches of <= 32 rows
    assert ce.calls <= 2 and srv.rows_served == 48
    assert all(s <= 32 for s in ce.sizes)
    for i, (d, ids) in enumerate(outs):
        _same(eng, qs[8 * i:8 * i + 8], d, ids, 5, cw, codes)


def test_server_partial_wave_flushes_on_timeout(small):
    cw, codes, qs, eng = small
    with CoalescingServer(eng, wave_rows=4096, max_wait_ms=20,
                          top_k=3) as srv:
        d, ids = srv.submit(qs[:5]).result(timeout=30)
    _same(eng, qs[:5], d, ids, 3, cw, codes)
    assert srv.dispatches == 1


def test_server_never_splits_a_submitted_wave(small):
    cw, codes, qs, eng = small

    class Sizes:
        def __init__(self, e):
            self.e, self.sizes = e, []

        def query(self, q, top_k):
            self.sizes.append(len(q))
            return self.e.query(q, top_k=top_k)

    se = Sizes(eng)
    with CoalescingServer(se, wave_rows=16, max_wait_ms=50,
                          top_k=3) as srv:
        futs = [srv.submit(qs[:12]), srv.submit(qs[12:24]),
                srv.submit(qs[24:36])]
        [f.result(timeout=30) for f in futs]
    # 12-row waves into 16-row dispatches: each dispatch is one wave
    assert all(s == 12 for s in se.sizes)


def test_server_survives_cancelled_future(small):
    """A cancelled pending future must not kill the dispatcher thread
    (``set_result`` on it would raise ``InvalidStateError``)."""
    cw, codes, qs, eng = small
    with CoalescingServer(eng, wave_rows=4096, max_wait_ms=100,
                          top_k=3) as srv:
        f1 = srv.submit(qs[:4])
        assert f1.cancel()           # still pending: cancel succeeds
        f2 = srv.submit(qs[4:12])    # must still resolve
        d, ids = f2.result(timeout=30)
    _same(eng, qs[4:12], d, ids, 3, cw, codes)


def test_server_empty_submit_and_close(small):
    cw, codes, qs, eng = small
    with CoalescingServer(eng, wave_rows=8, top_k=3) as srv:
        d, ids = srv.submit(qs[:0]).result(timeout=5)
        assert d.shape == (0, 3) and ids.shape == (0, 3)
        d2, ids2 = srv.query(qs[:8])
    _same(eng, qs[:8], d2, ids2, 3, cw, codes)
    with pytest.raises(RuntimeError):
        srv.submit(qs[:1])
    with pytest.raises(ValueError):
        CoalescingServer(eng, top_k=3).query(qs[:1], top_k=4)


def test_server_dedup_engine_under_concurrent_load():
    """The dedup tier behind the server: its host-side ``expand`` runs on
    the dispatcher thread; eight concurrent client waves resolve exactly
    and coalesce."""
    rng = np.random.default_rng(9)
    cw = rng.normal(size=(M, K, DS)).astype(np.float32)
    distinct = rng.integers(0, K, size=(64, M)).astype(np.uint8)
    codes = distinct[rng.integers(0, 64, size=3000)]
    eng = DedupCompressedEngine(cw, codes, device=CPU)
    qs = rng.normal(size=(64, M * DS)).astype(np.float32)
    results, errs = {}, []

    def client(i):
        try:
            results[i] = srv.submit(qs[i * 8:(i + 1) * 8]).result(timeout=60)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    with CoalescingServer(eng, wave_rows=32, max_wait_ms=20,
                          top_k=5) as srv:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert not errs and len(results) == 8 and srv.rows_served == 64
    for i in range(8):
        d, ids = results[i]
        _same(eng, qs[i * 8:(i + 1) * 8], d, ids, 5, cw, codes)
    assert srv.dispatches <= 4


def test_port_server_matches_jax_server(small):
    """The same waves through the JAX server over the JAX codes engine
    and the port's server over the port's compressed engine (bf16, the
    JAX default): distances within rtol 1e-5, atol 1e-4, ids up to
    ties."""
    cw, codes, qs, _ = small
    order = np.lexsort(codes.T[::-1])
    peng = FusedCompressedEngine(cw, codes[order], row_to_db=order,
                                 precision="bf16", device=CPU)
    jeng = JFusedCodesEngine(cw, codes)
    waves = [qs[:8], qs[8:20], qs[20:27], qs[27:48]]
    outs = {}
    for name, server, eng in (("port", CoalescingServer, peng),
                              ("jax", JServer, jeng)):
        with server(eng, wave_rows=24, max_wait_ms=5000, top_k=5) as srv:
            futs = [srv.submit(w) for w in waves]
            outs[name] = [f.result(timeout=60) for f in futs]
    for w, (d, ids), (jd, ji) in zip(waves, outs["port"], outs["jax"]):
        np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5, atol=1e-4)
        table = adc_table(torch.from_numpy(cw), torch.from_numpy(w)).numpy()
        assert_ids_up_to_ties(table, codes, ids, np.asarray(ji), 5)
