"""``ops/decoded.py`` (``decoded_topk``, ``DecodedEngine`` and its file)
and ``ops/topk.py`` (``smallest_k``) against the JAX package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deltapq_tpu.ops import decoded as jdecoded
from deltapq_tpu.ops import topk as jtopk
from deltapq_tpu.ops.adc import adc_table as j_adc_table
from deltapq_tpu_torch.convert import load_jax_decoded_engine
from deltapq_tpu_torch.ops import adc as padc
from deltapq_tpu_torch.ops import decoded as pdecoded
from deltapq_tpu_torch.ops import topk as ptopk

from _torch_port import (CPU, assert_ids_carry_dists, assert_ids_up_to_ties,
                         codebook, structured_codes)

CONFIGS = {"m8k256": (8, 256, 4), "m4k64": (4, 64, 8)}
N, B, TOPK = 3000, 12, 10


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    M, K, Ds = CONFIGS[request.param]
    rng = np.random.default_rng(M * K + 1)
    cw = codebook(rng, M, K, Ds)
    codes = structured_codes(rng, N, M, K)
    rows = codes[rng.integers(0, N, B)]
    queries = (np.concatenate([cw[m][rows[:, m]] for m in range(M)], 1)
               + rng.normal(size=(B, M * Ds)).astype(np.float32))
    table = np.array(j_adc_table(jnp.asarray(cw), jnp.asarray(queries)))
    return dict(M=M, K=K, cw=cw, codes=codes, queries=queries, table=table,
                jeng=jdecoded.DecodedEngine(cw, codes),
                peng=pdecoded.DecodedEngine(cw, codes, device=CPU))


def _jax_topk(jeng, table, queries, precision, rerank):
    d, i = jdecoded.decoded_topk(
        jeng.xhat_hi, jeng.xhat_lo, jeng.precomp, jnp.asarray(table),
        jeng.codes, jnp.asarray(queries), jnp.int32(jeng.n_valid), TOPK,
        precision, True, rerank)             # exact_select=True
    return np.asarray(d), np.asarray(i)


def _port_topk(peng, table, queries, precision, rerank):
    d, i = pdecoded.decoded_topk(
        peng.xhat_hi, peng.xhat_lo, peng.precomp, torch.from_numpy(table),
        peng.codes, torch.from_numpy(queries), peng.n_valid, TOPK,
        precision, rerank=rerank)
    return d.numpy(), i.numpy()


def test_engine_state_matches_jax(case):
    jeng, peng = case["jeng"], case["peng"]
    for name in ("xhat_hi", "xhat_lo"):
        assert np.array_equal(
            np.asarray(getattr(jeng, name).astype(jnp.float32)),
            getattr(peng, name).to(torch.float32).numpy())
    assert np.array_equal(np.asarray(jeng.precomp), peng.precomp.numpy())
    assert np.array_equal(np.asarray(jeng.codes), peng.codes.numpy())
    assert np.isinf(peng.precomp.numpy()[N:]).all()


def test_decoded_topk_with_rerank_matches_jax(case):
    """With the rerank the distances are exact table sums: the two
    frameworks differ by the table's own ulps."""
    jd, ji = _jax_topk(case["jeng"], case["table"], case["queries"],
                       "bf16x2", True)
    d, i = _port_topk(case["peng"], case["table"], case["queries"],
                      "bf16x2", True)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)
    assert_ids_up_to_ties(case["table"], case["codes"], i, ji, TOPK)
    assert_ids_carry_dists(case["table"], case["codes"], d, i)
    # the exact scan over the same table: the same bits
    dr, _ = padc.adc_query_topk(
        torch.from_numpy(case["table"]),
        torch.from_numpy(padc.pad_codes(case["codes"], 1024)), N, TOPK, 1024)
    assert np.array_equal(d, dr.numpy())
    # and through the engine, which builds its own table
    de, ie = case["peng"].query(case["queries"], top_k=TOPK)
    je, _ = case["jeng"].query(case["queries"], top_k=TOPK)
    np.testing.assert_allclose(de, je, rtol=1e-5, atol=1e-4)
    assert i.dtype == np.int32 and ie.shape == (B, TOPK)


@pytest.mark.parametrize("precision,rel", [("bf16x2", 2.0 ** -16),
                                           ("bf16", 2.0 ** -7)])
def test_decoded_topk_without_rerank_within_bound(case, precision, rel):
    """Without the rerank the distances are the matmul domain's.  The
    bf16 products are exact in f32 and both frameworks sum them in f32,
    so the two differ by summation order only: 2 D 2^-24 sum |x^ q|.
    Against the exact distance the split's own error is ~2^-18 (2^-9 at
    one product) of |x^||q|, taken with a factor 4."""
    jd, ji = _jax_topk(case["jeng"], case["table"], case["queries"],
                       precision, False)
    d, i = _port_topk(case["peng"], case["table"], case["queries"],
                      precision, False)
    q = case["queries"]
    xn = np.sqrt(case["peng"].precomp.numpy()[:N].max())
    qn = np.linalg.norm(q, axis=1).max()
    order_tol = 2 * q.shape[1] * 2.0 ** -24 * 2 * xn * qn
    np.testing.assert_allclose(d, jd, rtol=1e-6, atol=2 * order_tol)
    exact = np.sort(np.asarray(
        [[case["table"][b, np.arange(case["M"]), case["codes"][r]].sum()
          for r in i[b]] for b in range(B)], np.float32), axis=1)
    np.testing.assert_allclose(np.sort(d, axis=1), exact, rtol=1e-6,
                               atol=2 * rel * xn * qn + 2 * order_tol)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_decoded_engine_file_loads_in_both_packages(case, tmp_path, writer):
    path = str(tmp_path / f"{writer}_decoded.npz")
    (case["jeng"] if writer == "jax" else case["peng"]).save(path)
    jback = jdecoded.DecodedEngine.load(path)
    back = (load_jax_decoded_engine(path, device=CPU) if writer == "jax"
            else pdecoded.DecodedEngine.load(path, device=CPU))
    assert back.precision == "bf16x2" and back.n_valid == N
    with np.load(path) as z:
        assert z["xhat_hi"].dtype == np.uint16
        assert np.array_equal(
            z["xhat_hi"], np.asarray(case["jeng"].xhat_hi).view(np.uint16))
    d0, i0 = case["peng"].query(case["queries"], top_k=TOPK)
    d1, i1 = back.query(case["queries"], top_k=TOPK)
    assert np.array_equal(d0, d1) and np.array_equal(i0, i1)
    jd, ji = jback.query(case["queries"], top_k=TOPK)
    np.testing.assert_allclose(d1, jd, rtol=1e-5, atol=1e-4)
    assert_ids_up_to_ties(case["table"], case["codes"], i1, ji, TOPK)


def test_decoded_short_queries_and_bad_precision(case):
    peng = case["peng"]
    q = case["queries"][:, :-3]
    d, _ = peng.query(q, top_k=5)
    d2, _ = peng.query(np.pad(q, ((0, 0), (0, 3))), top_k=5)
    assert np.array_equal(d, d2)
    with pytest.raises(ValueError):
        _port_topk(peng, case["table"], case["queries"], "fp8", True)


@pytest.mark.parametrize("select", ["auto", "exact", "approx"])
@pytest.mark.parametrize("n,k", [(500, 10), (7, 10), (20000, 33)])
def test_smallest_k_matches_jax(select, n, k):
    d = np.random.default_rng(n + k).normal(size=(6, n)).astype(np.float32)
    # on the CPU every JAX select is exact too
    jv, ji = jtopk.smallest_k(jnp.asarray(d), k, select)
    v, i = ptopk.smallest_k(torch.from_numpy(d), k, select)
    assert np.array_equal(v.numpy(), np.asarray(jv))
    assert np.array_equal(i.numpy(), np.asarray(ji))
    with pytest.raises(ValueError):
        ptopk.smallest_k(torch.from_numpy(d), k, "fastest")
