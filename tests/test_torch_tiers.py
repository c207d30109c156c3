"""The index tiers of the port against the JAX package, on the same NumPy
inputs: the decoded cache, the plain versions of the decoded (B4), codes
(B3) and bf16 stream (B1) kernels against the Pallas kernels in
interpret mode, and each engine against the JAX engine."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deltapq_tpu.ops import decoded as jdecoded
from deltapq_tpu.ops import fused as jfused
from deltapq_tpu.ops import fused_pallas as jfp
from deltapq_tpu.ops.adc import adc_table as j_adc_table
from deltapq_tpu_torch.kernels import build
from deltapq_tpu_torch.ops import fused as pfused
from deltapq_tpu_torch.ops import fused_kernels as fk
from deltapq_tpu_torch.ops.adc import adc_query_topk, pad_codes
from deltapq_tpu_torch.ops.decoded import build_decoded_cache

from _torch_port import (CPU, assert_ids_carry_dists, assert_ids_up_to_ties,
                         codebook, structured_codes)

CONFIGS = {"m8k256": (8, 256, 4), "m4k32": (4, 32, 4),
           "m8k64ds16": (8, 64, 16),
           "m16k16": (16, 16, 4)}     # two groups, two mask planes
N, B, TOPK = 5000, 64, 10


def bf16_tol(pre_max, cross_max):
    """Bound for two f32 sums of the same exact bf16 products in two
    orders: each is off by at most (D-1) * 2^-24 * sum |terms| (D <= 128,
    so < 7.6e-6 of it) and sum |x^ q| <= the cross bound sqrt(max pre) *
    max ||q|| (Cauchy-Schwarz); 2e-5 covers both sides and the final
    pre - 2 cross rounding."""
    return 2e-5 * (pre_max + 2 * cross_max)


def int16_tol(pre_max, cross_max):
    """The int16 digit products are exact on both sides; only the f32
    pre sum and the digit combination round (the bound of
    tests/test_torch_fused.py)."""
    return 4e-6 * (pre_max + 2 * cross_max)


def assert_mins_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.abs(got[fin] - want[fin]).max() <= tol


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    M, K, Ds = CONFIGS[request.param]
    rng = np.random.default_rng(M * 100 + K + Ds)
    cw = codebook(rng, M, K, Ds)
    codes = structured_codes(rng, N, M, K)
    rows = codes[rng.integers(0, N, B)]
    queries = (np.concatenate([cw[m][rows[:, m]] for m in range(M)], 1)
               + rng.normal(size=(B, M * Ds)).astype(np.float32))
    return dict(M=M, K=K, Ds=Ds, cw=cw, codes=codes, queries=queries)


def _centered(case, d_pad, mu):
    q, _ = pfused._pad_queries(case["queries"], d_pad)
    return q - mu[None, :]


def test_decoded_cache_bit_equal(case):
    cw, codes = case["cw"], case["codes"]
    mu = fk.codebook_center(cw)
    jh, jl, jp = jdecoded.build_decoded_cache(cw, codes, batch=1500,
                                              center=mu)
    h, lo, p = build_decoded_cache(cw, codes, batch=1500, center=mu)
    assert np.array_equal(h.view(torch.int16).numpy(),
                          np.asarray(jh).view(np.int16))
    assert np.array_equal(lo.view(torch.int16).numpy(),
                          np.asarray(jl).view(np.int16))
    assert np.array_equal(p, jp)
    xt = fk.pack_xhat_tiles(h, tile=2048)
    jxt = jfp.pack_xhat_tiles(np.asarray(jh), tile=2048)
    assert np.array_equal(xt.view(torch.int16).numpy(), jxt.view(np.int16))


def test_decoded_mins_plain_matches_jax_kernel(case):
    peng = pfused.FusedDecodedEngine(case["cw"], case["codes"], device=CPU)
    qc = _centered(case, peng.d_pad, peng.mu)
    qop, uq, (q2, _, _) = peng._query_operands(qc)
    jq = jnp.asarray(qc.astype(jnp.bfloat16).T)
    assert np.array_equal(qop.view(torch.int16).numpy(),
                          np.asarray(jq).view(np.int16))
    jxt = jnp.asarray(peng.xt.view(torch.int16).numpy()).view(jnp.bfloat16)
    jm = jfp.fused_decoded_mins(jq, jxt, jnp.int32(N))
    mins, pre_max, cross_max = fk.fused_decoded_mins_ref(qop, peng.xt, N)
    assert_mins_close(mins.numpy(), jm, bf16_tol(pre_max, cross_max))
    before = build.launch_counts()
    assert torch.equal(peng.scan(qop, uq)[0], mins)     # CPU: the plain one
    assert build.launch_counts() == before


@pytest.mark.parametrize("precision", ["bf16", "int16"])
def test_codes_mins_plain_matches_jax_kernel(case, precision):
    M, Ds = case["M"], case["Ds"]
    jeng = jfused.FusedCodesEngine(case["cw"], case["codes"],
                                   precision=precision)
    peng = pfused.FusedCodesEngine(case["cw"], case["codes"],
                                   precision=precision, device=CPU)
    if precision == "bf16":
        assert np.array_equal(peng.cwbd.view(torch.int16).numpy(),
                              np.asarray(jeng.cwbd).view(np.int16))
    else:
        assert np.array_equal(peng.cwbd.numpy(), np.asarray(jeng.cwbd))
    assert np.array_equal(peng.codes.numpy(), np.asarray(jeng.codes))
    qc = _centered(case, peng.d_pad, peng.mu)
    qk = fk.pack_query_grouped(qc[:, :peng.D], M, Ds)
    jq, _, ju, _ = jfused._mins_query_args(qk, precision, jeng.scale)
    qop, uq, _ = peng._query_operands(qc)
    if precision == "bf16":
        assert uq is None and ju is None
        assert np.array_equal(qop.view(torch.int16).numpy(),
                              np.asarray(jq).view(np.int16))
    else:
        assert np.array_equal(qop.numpy(), np.asarray(jq))
        assert np.array_equal(uq.numpy(), np.asarray(ju))
    jm, jecho = jfp.fused_codes_mins(jq, jeng.cwbd, jeng.codes,
                                     jnp.int32(N), u=ju,
                                     int16=precision == "int16")
    mins, echo, pre_max, cross_max = fk.fused_codes_mins_ref(
        qop, peng.cwbd, peng.codes, N, u=uq, mode=precision)
    assert np.array_equal(echo.numpy(), np.asarray(jecho))
    tol = (bf16_tol if precision == "bf16" else int16_tol)(pre_max,
                                                          cross_max)
    assert_mins_close(mins.numpy(), jm, tol)


def test_stream_mins_bf16_plain_matches_jax_kernel(case):
    M, Ds, codes = case["M"], case["Ds"], case["codes"]
    order = np.lexsort(codes.T[::-1])
    jeng = jfused.FusedCompressedEngine(case["cw"], codes[order],
                                        row_to_db=order, precision="bf16")
    peng = pfused.FusedCompressedEngine.from_tiles(
        case["cw"], jeng.tiles, row_to_db=order, precision="bf16", device=CPU)
    qc = _centered(case, peng.d_pad, peng.mu)
    qk = fk.pack_query_grouped(qc[:, :peng.D], M, Ds)
    jq, _, ju, _ = jfused._mins_query_args(qk, "bf16", None)
    qop, uq, _ = peng._query_operands(qc)
    assert np.array_equal(qop.view(torch.int16).numpy(),
                          np.asarray(jq).view(np.int16))
    jm, jecho = jfp.fused_stream_mins(
        jq, jeng.cwbd, jeng.row_data, jeng.vals, jeng.meta, jnp.int32(N),
        jeng.tiles.e_max, M, u=ju, int16=False)
    mins, echo, pre_max, cross_max = fk.fused_stream_mins_ref(
        qop, peng.cwbd, peng.row_data, peng.vals, peng.meta, N, M,
        mode="bf16")
    assert np.array_equal(echo.numpy(), np.asarray(jecho))
    assert_mins_close(mins.numpy(), jm, bf16_tol(pre_max, cross_max))


def _check_engine(case, peng, jeng):
    """The port's engine against the JAX engine (rtol 1e-5, atol 1e-4:
    the tables differ by ulps between the frameworks' f32 matmuls; ids
    up to ties) and bit-equal to the port's own exact scan over its
    table."""
    queries, codes = case["queries"], case["codes"]
    jd, ji = jeng.query(queries, top_k=TOPK)
    d, i = peng.query(queries, top_k=TOPK)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)
    table = pfused.adc_table(
        torch.from_numpy(case["cw"]),
        torch.from_numpy(pfused._pad_queries(queries, peng.d_pad)[0]
                         [:, :case["M"] * case["Ds"]]))[:len(queries)]
    assert_ids_up_to_ties(table.numpy(), codes, i, np.asarray(ji), TOPK)
    dr, _ = adc_query_topk(table, torch.from_numpy(pad_codes(codes, 1024)),
                           len(codes), TOPK, 1024)
    assert np.array_equal(d, dr.numpy())
    assert_ids_carry_dists(table.numpy(), codes, d, i)


def test_decoded_engine_matches_jax(case):
    _check_engine(case,
                  pfused.FusedDecodedEngine(case["cw"], case["codes"],
                                            device=CPU),
                  jfused.FusedDecodedEngine(case["cw"], case["codes"]))


@pytest.mark.parametrize("precision", ["bf16", "int16"])
def test_codes_engine_matches_jax(case, precision):
    order = np.random.default_rng(3).permutation(N)
    _check_engine(case,
                  pfused.FusedCodesEngine(case["cw"], case["codes"],
                                          order=order, precision=precision,
                                          device=CPU),
                  jfused.FusedCodesEngine(case["cw"], case["codes"],
                                          order=order, precision=precision))


def test_compressed_bf16_engine_matches_jax(case):
    codes = case["codes"]
    order = np.lexsort(codes.T[::-1])
    peng = pfused.FusedCompressedEngine(case["cw"], codes[order],
                                        row_to_db=order, precision="bf16",
                                        device=CPU)
    assert peng.precision == "bf16" and peng.scale is None
    _check_engine(case, peng,
                  jfused.FusedCompressedEngine(case["cw"], codes[order],
                                               row_to_db=order,
                                               precision="bf16"))


def test_dedup_engine_matches_jax(case):
    peng = pfused.DedupCompressedEngine(case["cw"], case["codes"], device=CPU)
    jeng = jfused.DedupCompressedEngine(case["cw"], case["codes"])
    assert peng.n_unique == jeng.n_unique
    assert np.array_equal(peng.order, jeng.order)
    _check_engine(case, peng, jeng)
    assert peng.bytes_per_vec() == pytest.approx(jeng.bytes_per_vec())


def test_exact_all_topk_matches_jax(case):
    cw, codes = case["cw"], case["codes"]
    q, _ = pfused._pad_queries(case["queries"], 128)
    D = case["M"] * case["Ds"]
    table = np.array(j_adc_table(jnp.asarray(cw), jnp.asarray(q[:, :D])))
    cp = pad_codes(codes, 1024)
    jd, ji = jfused.exact_all_topk(jnp.asarray(table), jnp.asarray(cp),
                                   jnp.int32(N), TOPK)
    d, i = pfused.exact_all_topk(torch.from_numpy(table),
                                 torch.from_numpy(cp), N, TOPK)
    # the JAX sum runs as three bf16-digit matmuls (f32-faithful)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-5)
    assert_ids_up_to_ties(table, codes, i.numpy(), np.asarray(ji), TOPK)
    dr, _ = adc_query_topk(torch.from_numpy(table), torch.from_numpy(cp),
                           N, TOPK, 1024)
    assert torch.equal(d, dr)                 # bit-equal to the plain scan


def test_unported_precisions_raise(case, monkeypatch):
    """A precision the JAX package lacks raises; above the exact-all
    regime the dedup tier's inner engine runs at every ported precision,
    its int8 default included, with the exact-all results."""
    cw, codes = case["cw"], case["codes"]
    with pytest.raises(NotImplementedError, match="int8, int16 and bf16"):
        pfused.FusedCodesEngine(cw, codes, precision="fp8", device=CPU)
    d0, _ = pfused.DedupCompressedEngine(cw, codes,
                                         device=CPU).query(case["queries"],
                                                          top_k=TOPK)
    monkeypatch.setattr(pfused.DedupCompressedEngine, "EXACT_ALL_MAX_ROWS",
                        100)
    for precision in ("int8", "int16"):
        eng = pfused.DedupCompressedEngine(cw, codes, precision=precision,
                                           device=CPU)
        assert eng.engine is not None and eng.engine.precision == precision
        d, _ = eng.query(case["queries"], top_k=TOPK)
        assert np.array_equal(d, d0)
