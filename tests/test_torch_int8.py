"""The int8 precision and the slot-tile format of the port against the
JAX package, on the same NumPy inputs: the int8 host operands, the plain
versions of the int8 scans (stream B1, codes B3, slots B5) and of B5 in
its other modes against the Pallas kernels in interpret mode, the slot
tiles byte for byte, and the int8 engines against the JAX engines."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deltapq_tpu.ops import delta_tiles as jdt
from deltapq_tpu.ops import fused as jfused
from deltapq_tpu.ops import fused_pallas as jfp
from deltapq_tpu_torch.kernels import build
from deltapq_tpu_torch.ops import delta_tiles as pdt
from deltapq_tpu_torch.ops import fused as pfused
from deltapq_tpu_torch.ops import fused_kernels as fk
from deltapq_tpu_torch.ops.adc import adc_query_topk, pad_codes

from _torch_port import (CPU, assert_ids_carry_dists, assert_ids_up_to_ties,
                         codebook, structured_codes)

CONFIGS = {"m8k256": (8, 256, 4), "m4k16": (4, 16, 4),
           "m16k16": (16, 16, 4)}     # two groups, two mask planes
N, B, TOPK = 3000, 64, 10


def int16_tol(pre_max, cross_max):
    """int16 digit products are exact on both sides; the f32 pre sum and
    the digit combination round (tests/test_torch_fused.py)."""
    return 4e-6 * (pre_max + 2 * cross_max)


def bf16_tol(pre_max, cross_max):
    """Two f32 sums of the same exact bf16 products in two orders
    (tests/test_torch_tiers.py)."""
    return 2e-5 * (pre_max + 2 * cross_max)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    """Scan-ordered codes with their slot tiles (built by the JAX
    package), shared queries and each precision's JAX query operands."""
    M, K, Ds = CONFIGS[request.param]
    rng = np.random.default_rng(M * 10 + K)
    cw = codebook(rng, M, K, Ds)
    codes = structured_codes(rng, N, M, K)
    order = np.lexsort(codes.T[::-1])
    rows = codes[rng.integers(0, N, B)]
    queries = (np.concatenate([cw[m][rows[:, m]] for m in range(M)], 1)
               + rng.normal(size=(B, M * Ds)).astype(np.float32))
    jeng = {p: jfused.FusedCompressedEngine(cw, codes[order],
                                            row_to_db=order, precision=p,
                                            fmt="slots")
            for p in ("int8", "int16", "bf16")}
    jops = {}
    for p, e in jeng.items():
        q, _ = jfused._pad_queries(queries, e.d_pad)
        qk = jfp.pack_query_grouped((q - e.mu[None])[:, :e.D], M, Ds)
        jops[p] = (qk,) + jfused._mins_query_args(qk, p, e.scale)
    return dict(M=M, K=K, Ds=Ds, cw=cw, codes=codes, order=order,
                queries=queries, jeng=jeng, jops=jops)


def _port_ops(case, precision):
    """The port's query operands from the same grouped queries."""
    e = case["jeng"][precision]
    qk = case["jops"][precision][0]
    return pfused._mins_query_args(qk, precision, e.scale, "cpu")


def test_int8_host_operands_equal(case):
    cw, M, Ds = case["cw"], case["M"], case["Ds"]
    jeng = case["jeng"]["int8"]
    mu = fk.codebook_center(cw)
    a, sa = fk.quantize_blockdiag_int8(cw, center=mu)
    b, sb = jfp.quantize_blockdiag_int8(cw, center=mu)
    assert sa == sb and np.array_equal(a, b)
    # from a block-diagonal f32 matrix as well
    bd = jfp.build_blockdiag_codebook(cw, mu, np.float32)
    a, sa = fk.quantize_blockdiag_int8(bd)
    b, sb = jfp.quantize_blockdiag_int8(bd)
    assert sa == sb and np.array_equal(a, b)
    assert (pfused._int8_codeword_radius(cw, jeng.mu, jeng.scale)
            == jfused._int8_codeword_radius(cw, jeng.mu, jeng.scale))
    peng = pfused.FusedCompressedEngine(cw, case["codes"][case["order"]],
                                        precision="int8", fmt="slots",
                                        device=CPU)
    assert peng.scale == jeng.scale and peng.err_c == jeng.err_c
    assert np.array_equal(peng.cwbd.numpy(), np.asarray(jeng.cwbd))
    _, jq, _, ju, jeq = case["jops"]["int8"]
    qop, uq, eq = _port_ops(case, "int8")
    G, _, Dg_pad = fk.group_geometry(M, Ds)    # d_pad for one group
    assert qop.dtype == torch.int8 and qop.shape[0] == G * Dg_pad
    assert np.array_equal(qop.numpy(), np.asarray(jq))
    assert np.array_equal(uq.numpy(), np.asarray(ju))
    assert np.array_equal(eq.numpy(), np.asarray(jeq))
    # the int8 certificate inputs are bit-equal: sum of squares of
    # integers below 2^24 is exact in f32 in any order
    q2, err_r, scale2 = pfused._quantized_query_stats(peng, qop, uq, eq)
    jq2, jerr, js2 = jfused._quantized_query_stats(jeng, jq, ju, jeq)
    assert np.array_equal(q2.numpy(), np.asarray(jq2))
    assert np.array_equal(err_r.numpy(), np.asarray(jerr))
    assert float(scale2) == float(js2)


def _assert_mins_bit_equal(got, want):
    """int8 scans: every partial sum is an integer below 2^24 (exact in
    f32 in any order), then cross*u and pre - 2 cross round once each in
    the same order, so the plain version and the Pallas kernel agree bit
    for bit (the f32 matmuls run with TF32 off)."""
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_int8_stream_mins_plain_bit_equal_to_jax(case):
    M, codes, order = case["M"], case["codes"], case["order"]
    jeng = jfused.FusedCompressedEngine(case["cw"], codes[order],
                                        row_to_db=order, precision="int8")
    peng = pfused.FusedCompressedEngine.from_tiles(
        case["cw"], jeng.tiles, row_to_db=order, precision="int8", device=CPU)
    _, jq, _, ju, _ = case["jops"]["int8"]
    qop, uq, _ = _port_ops(case, "int8")
    jm, jecho = jfp.fused_stream_mins(
        jq, jeng.cwbd, jeng.row_data, jeng.vals, jeng.meta, jnp.int32(N),
        jeng.tiles.e_max, M, u=ju, int16=False)
    mins, echo, _, _ = fk.fused_stream_mins_ref(
        qop, peng.cwbd, peng.row_data, peng.vals, peng.meta, N, M, u=uq,
        mode="int8")
    assert np.array_equal(echo.numpy(), np.asarray(jecho))
    _assert_mins_bit_equal(mins.numpy(), jm)
    assert torch.equal(peng.scan(qop, uq)[0], mins)     # CPU: the plain one


def test_int8_codes_mins_plain_bit_equal_to_jax(case):
    jeng = jfused.FusedCodesEngine(case["cw"], case["codes"],
                                   precision="int8")
    peng = pfused.FusedCodesEngine(case["cw"], case["codes"],
                                   precision="int8", device=CPU)
    assert np.array_equal(peng.codes.numpy(), np.asarray(jeng.codes))
    _, jq, _, ju, _ = case["jops"]["int8"]
    qop, uq, _ = _port_ops(case, "int8")
    jm, jecho = jfp.fused_codes_mins(jq, jeng.cwbd, jeng.codes,
                                     jnp.int32(N), u=ju)
    mins, echo, _, _ = fk.fused_codes_mins_ref(qop, peng.cwbd, peng.codes,
                                               N, u=uq, mode="int8")
    assert np.array_equal(echo.numpy(), np.asarray(jecho))
    _assert_mins_bit_equal(mins.numpy(), jm)


@pytest.mark.parametrize("precision", ["int8", "int16", "bf16"])
def test_delta_mins_plain_matches_jax(case, precision):
    """B5's plain version against ``_delta_mins_kernel`` in each mode:
    echo exact; mins bit-equal (int8) or within the int16 / bf16 bounds.
    On the CPU the wrapper runs the plain version, unlaunched."""
    jeng = case["jeng"][precision]
    peng = pfused.FusedCompressedEngine.from_tiles(
        case["cw"], jeng.tiles, row_to_db=case["order"],
        precision=precision, device=CPU)
    assert peng.fmt == "slots"
    _, jq, _, ju, _ = case["jops"][precision]
    qop, uq, _ = _port_ops(case, precision)
    jm, jecho = jfp.fused_delta_mins(
        jq, jeng.cwbd, jeng.row_data, jeng.ovf, jnp.int32(N),
        jeng.tiles.S, u=ju, int16=precision == "int16")
    mins, echo, pre_max, cross_max = fk.fused_delta_mins_ref(
        qop, peng.cwbd, peng.row_data, peng.ovf, N, peng.tiles.S, u=uq,
        mode=precision)
    assert np.array_equal(echo.numpy(), np.asarray(jecho))
    assert np.array_equal(echo[:N].numpy(),
                          case["codes"][case["order"]])
    jm = np.asarray(jm)
    if precision == "int8":
        _assert_mins_bit_equal(mins.numpy(), jm)
    else:
        tol = (int16_tol if precision == "int16" else bf16_tol)(pre_max,
                                                               cross_max)
        fin = np.isfinite(jm)
        assert np.array_equal(fin, np.isfinite(mins.numpy()))
        assert np.abs(mins.numpy()[fin] - jm[fin]).max() <= tol
    before = build.launch_counts()
    m2, e2 = peng.scan(qop, uq)
    assert build.launch_counts() == before
    assert torch.equal(m2, mins) and torch.equal(e2, echo)


@pytest.mark.parametrize("S", [None, 1, 2])
def test_delta_tiles_byte_equal(case, S):
    """The tile packer (its choice of S included), the NumPy oracle decode
    and the plain PyTorch decode against the JAX package's."""
    codes = case["codes"][case["order"]]
    jt = jdt.build_delta_tiles(codes, S=S)
    pt = pdt.build_delta_tiles(codes, S=S)
    assert (pt.S, pt.Cap, pt.M, pt.n_valid) == (jt.S, jt.Cap, jt.M,
                                                jt.n_valid)
    assert pt.row_data.dtype == np.uint8 and pt.ovf.dtype == np.uint8
    assert np.array_equal(pt.row_data, jt.row_data)
    assert np.array_equal(pt.ovf, jt.ovf)
    assert pt.bytes_per_vec() == jt.bytes_per_vec()
    assert np.array_equal(pdt.decode_delta_tiles(pt), codes)
    assert np.array_equal(jdt.decode_delta_tiles(jt), codes)
    dec = fk.decode_delta_tiles_torch(torch.from_numpy(pt.row_data),
                                      torch.from_numpy(pt.ovf), pt.S,
                                      pt.M)
    assert np.array_equal(dec[:N].numpy(), codes)
    bits = np.random.default_rng(S or 0).random((50, 11)) < 0.4
    assert np.array_equal(pdt._mask_planes(bits), jdt._mask_planes(bits))
    assert np.array_equal(pdt._full_planes(11), jdt._full_planes(11))
    with pytest.raises(ValueError):
        pdt.build_delta_tiles(codes, S=case["M"])


def _check_engine(case, peng, jeng):
    """The port's engine against the JAX engine (rtol 1e-5, atol 1e-4:
    the tables differ by ulps between the frameworks' f32 matmuls; ids
    up to ties) and bit-equal to the port's own exact scan."""
    queries, codes = case["queries"], case["codes"]
    jd, ji = jeng.query(queries, top_k=TOPK)
    d, i = peng.query(queries, top_k=TOPK)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)
    table = peng.prepare(queries)[0][:len(queries)]
    assert_ids_up_to_ties(table.numpy(), codes, i, np.asarray(ji), TOPK)
    dr, _ = adc_query_topk(table, torch.from_numpy(pad_codes(codes, 1024)),
                           len(codes), TOPK, 1024)
    assert np.array_equal(d, dr.numpy())
    assert_ids_carry_dists(table.numpy(), codes, d, i)


@pytest.mark.parametrize("tier", ["stream", "slots", "codes"])
def test_int8_engines_match_jax(case, tier):
    cw, codes, order = case["cw"], case["codes"], case["order"]
    if tier == "codes":
        perm = np.random.default_rng(3).permutation(N)
        peng = pfused.FusedCodesEngine(cw, codes, order=perm,
                                       precision="int8", device=CPU)
        jeng = jfused.FusedCodesEngine(cw, codes, order=perm,
                                       precision="int8")
    else:
        peng = pfused.FusedCompressedEngine(cw, codes[order],
                                            row_to_db=order,
                                            precision="int8", fmt=tier,
                                            device=CPU)
        jeng = (case["jeng"]["int8"] if tier == "slots" else
                jfused.FusedCompressedEngine(cw, codes[order],
                                             row_to_db=order,
                                             precision="int8"))
        assert peng.fmt == tier
        assert peng.bytes_per_vec() == jeng.bytes_per_vec()
    assert peng.precision == "int8" and peng.cwbd.dtype == torch.int8
    _check_engine(case, peng, jeng)
    assert 0.0 <= peng.last_exact_frac <= 1.0


def test_scan_mode_mismatch_raises(case):
    """The mode is explicit: operands of another mode raise, on the CPU
    as on the card."""
    e8 = case["jeng"]["int8"]
    peng = pfused.FusedCompressedEngine.from_tiles(case["cw"], e8.tiles,
                                                   precision="int8",
                                                   device=CPU)
    qop, uq, _ = _port_ops(case, "int8")
    args = (peng.row_data, peng.ovf, N, peng.tiles.S)
    # int8 operands ([Dg]-wide) in the int16 mode ([2*Dg]-wide)
    with pytest.raises(ValueError, match="int16 mode"):
        fk.fused_delta_mins(qop, peng.cwbd, *args, u=uq, mode="int16")
    # int8 operands in the bf16 mode, and a missing mode
    with pytest.raises(ValueError):
        fk.fused_delta_mins(qop, peng.cwbd, *args, u=uq, mode="bf16")
    with pytest.raises(TypeError):
        fk.fused_delta_mins(qop, peng.cwbd, *args, u=uq)
    # slot rows that disagree with S
    with pytest.raises(ValueError, match="1 <= S < M"):
        fk.fused_delta_mins(qop, peng.cwbd, peng.row_data, peng.ovf, N,
                            peng.tiles.S + 1, u=uq, mode="int8")
    with pytest.raises(NotImplementedError):
        fk.compact_codebook(peng.cwbd, case["M"], case["Ds"], "int4")
