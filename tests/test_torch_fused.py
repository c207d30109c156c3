"""The port's scan kernels' plain versions, selection epilogue and engine
against the JAX package, on the same NumPy inputs.  The JAX side runs
as its own tests run it on the CPU (Pallas in interpret mode)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deltapq_tpu.ops import fused_pallas as jfp
from deltapq_tpu.ops import fused as jfused
from deltapq_tpu.ops.adc import adc_table as j_adc_table
from deltapq_tpu_torch.convert import engine_state_from_numpy, load_jax_engine
from deltapq_tpu_torch.kernels import build
from deltapq_tpu_torch.ops import fused as pfused
from deltapq_tpu_torch.ops import fused_kernels as fk
from deltapq_tpu_torch.ops.adc import adc_query_topk, pad_codes
from deltapq_tpu_torch.ops.fused import FusedCompressedEngine
from deltapq_tpu_torch.ops.stream_tiles import (build_stream_tiles,
                                                decode_stream_tiles)
from deltapq_tpu_torch.tree.build import find_edges_by_diff
from deltapq_tpu_torch.tree.layout import build_layout

from _torch_port import (CPU, assert_ids_carry_dists, assert_ids_up_to_ties,
                         codebook, structured_codes)

CONFIGS = {"m8k256": (8, 256, 4), "m4k32": (4, 32, 4),
           "m16k16": (16, 16, 4)}     # two groups, two mask planes
N, B, TOPK = 6000, 128, 10


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request, tmp_path_factory):
    """A JAX int16 stream engine, the port's engine converted from its
    saved state, shared queries and the JAX kernel's outputs."""
    M, K, Ds = CONFIGS[request.param]
    rng = np.random.default_rng(M * 1000 + K)
    cw = codebook(rng, M, K, Ds)
    codes = structured_codes(rng, N, M, K)
    order = np.lexsort(codes.T[::-1])
    jeng = jfused.FusedCompressedEngine(cw, codes[order], row_to_db=order,
                                        precision="int16")
    path = str(tmp_path_factory.mktemp("eng") / "jax_engine.npz")
    jeng.save(path)
    peng = load_jax_engine(path, device=CPU)
    rows = codes[rng.integers(0, N, B)]
    queries = (np.concatenate([cw[m][rows[:, m]] for m in range(M)], 1)
               + rng.normal(size=(B, M * Ds)).astype(np.float32))
    # the JAX kernel on the shared operands
    q, b = jfused._pad_queries(queries, jeng.d_pad)
    qk = jfp.pack_query_grouped((q - jeng.mu[None])[:, :jeng.D], M, Ds)
    qop, _, uq, eq = jfused._mins_query_args(qk, "int16", jeng.scale)
    jmins, jecho = jfp.fused_stream_mins(
        qop, jeng.cwbd, jeng.row_data, jeng.vals, jeng.meta,
        jnp.int32(jeng.n_valid), jeng.tiles.e_max, M, u=uq, int16=True)
    return dict(M=M, K=K, Ds=Ds, cw=cw, codes=codes, order=order,
                jeng=jeng, peng=peng, queries=queries, qk=qk,
                qop=np.array(qop), uq=np.array(uq), eq=np.array(eq),
                jmins=np.array(jmins), jecho=np.array(jecho))


def test_host_operands_equal(case):
    M, K, Ds, cw = case["M"], case["K"], case["Ds"], case["cw"]
    mu = jfp.codebook_center(cw)
    assert np.array_equal(fk.codebook_center(cw), mu)
    assert fk.group_geometry(M, Ds) == jfp.group_geometry(M, Ds)
    assert np.array_equal(
        fk.build_blockdiag_codebook(cw, mu, torch.float32).numpy(),
        jfp.build_blockdiag_codebook(cw, mu, np.float32))
    # the bf16 default, bit for bit
    assert np.array_equal(
        fk.build_blockdiag_codebook(cw, mu).view(torch.int16).numpy(),
        np.asarray(jfp.build_blockdiag_codebook(cw, mu)).view(np.int16))
    a, sa = fk.quantize_blockdiag_int16(cw, center=mu)
    b, sb = jfp.quantize_blockdiag_int16(cw, center=mu)
    assert sa == sb and np.array_equal(a, b)
    peng, jeng = case["peng"], case["jeng"]
    assert peng.scale == jeng.scale and peng.err_c == jeng.err_c
    assert np.array_equal(peng.cwbd.numpy(), np.asarray(jeng.cwbd))
    q, _ = pfused._pad_queries(case["queries"], peng.d_pad)
    qk = fk.pack_query_grouped((q - peng.mu[None])[:, :peng.D], M, Ds)
    assert np.array_equal(qk, case["qk"])
    qop, uq, eq = pfused._mins_query_args(qk, "int16", peng.scale, "cpu")
    assert np.array_equal(qop.numpy(), case["qop"])
    assert np.array_equal(uq.numpy(), case["uq"])
    assert np.array_equal(eq.numpy(), case["eq"])


def test_stream_mins_plain_matches_jax_kernel(case):
    peng = case["peng"]
    qop = torch.from_numpy(case["qop"])
    uq = torch.from_numpy(case["uq"])
    mins, echo, pre_max, cross_max = fk.fused_stream_mins_ref(
        qop, peng.cwbd, peng.row_data, peng.vals, peng.meta, peng.n_valid,
        case["M"], u=uq, mode="int16")
    assert np.array_equal(echo.numpy(), case["jecho"])
    jm = case["jmins"]
    fin = np.isfinite(jm)
    assert np.array_equal(fin, np.isfinite(mins.numpy()))
    tol = 4e-6 * (pre_max + 2 * cross_max)
    assert np.abs(mins.numpy()[fin] - jm[fin]).max() <= tol
    # the wrapper takes the plain version for CPU tensors, unlaunched
    before = build.launch_counts()
    m2, e2 = peng.scan(qop, uq)
    assert build.launch_counts() == before
    assert torch.equal(m2, mins) and torch.equal(e2, echo)


@pytest.mark.parametrize("Bq,M,K,S", [(16, 8, 256, 1500), (8, 4, 32, 96)])
def test_rerank_plain_bit_equal_to_jax(Bq, M, K, S):
    rng = np.random.default_rng(S)
    tab = (rng.normal(size=(Bq, M * K)) * 50).astype(np.float32)
    cand = rng.integers(0, K, size=(Bq, M, S)).astype(np.uint8)
    want = np.asarray(jfp.rerank_table_sums(jnp.asarray(tab),
                                            jnp.asarray(cand)))
    got = fk.rerank_table_sums(torch.from_numpy(tab), torch.from_numpy(cand))
    assert np.array_equal(got.numpy(), want)


def _cert_inputs(case):
    peng = case["peng"]
    qop = torch.from_numpy(case["qop"])
    uq = torch.from_numpy(case["uq"])
    q2, err_r, scale2 = pfused._quantized_query_stats(
        peng, qop, uq, torch.from_numpy(case["eq"]))
    jq2, jerr, js2 = jfused._quantized_query_stats(
        case["jeng"], jnp.asarray(case["qop"]), jnp.asarray(case["uq"]),
        jnp.asarray(case["eq"]))
    # the f32 sum over D of A^2 rounds in another order in each framework
    np.testing.assert_allclose(q2.numpy(), np.asarray(jq2), rtol=1e-6)
    assert np.array_equal(err_r.numpy(), np.asarray(jerr))
    assert float(scale2) == float(js2)
    q, _ = pfused._pad_queries(case["queries"], peng.d_pad)
    table = np.array(j_adc_table(jnp.asarray(case["cw"]),
                                   jnp.asarray(q[:, :peng.D])))
    # both packages get the same certificate inputs from here on
    return torch.from_numpy(np.array(jq2)), err_r, scale2, table


def test_select_rerank_matches_jax(case):
    q2, err_r, scale2, table = _cert_inputs(case)
    jm = case["jmins"]
    mins_bn = (jm.T * np.float32(scale2)).astype(np.float32)
    n_sub, n_valid = 40, case["peng"].n_valid
    jd, jr, jok = jfp.select_rerank(
        jnp.asarray(mins_bn), jnp.asarray(q2.numpy()), jnp.asarray(table),
        jnp.asarray(case["jecho"]), jnp.int32(n_valid), TOPK, n_sub,
        prepooled=True, err_r=jnp.asarray(err_r.numpy()))
    d, r, ok = fk.select_rerank(
        torch.from_numpy(mins_bn), q2, torch.from_numpy(table),
        torch.from_numpy(case["jecho"]), n_valid, TOPK, n_sub,
        prepooled=True, err_r=err_r)
    assert np.array_equal(d.numpy(), np.asarray(jd))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    scan_codes = case["jecho"][:n_valid]
    assert_ids_carry_dists(table, scan_codes, d.numpy(), r.numpy())
    assert_ids_up_to_ties(table, scan_codes, r.numpy(), np.asarray(jr),
                          TOPK)
    # the bf16-domain certificate (no radius): the fence margin
    _, _, jok = jfp.select_rerank(
        jnp.asarray(mins_bn), jnp.asarray(q2.numpy()), jnp.asarray(table),
        jnp.asarray(case["jecho"]), jnp.int32(n_valid), TOPK, n_sub,
        prepooled=True)
    _, _, ok = fk.select_rerank(
        torch.from_numpy(mins_bn), q2, torch.from_numpy(table),
        torch.from_numpy(case["jecho"]), n_valid, TOPK, n_sub,
        prepooled=True)
    assert np.array_equal(ok.numpy(), np.asarray(jok))


def test_ladder_and_terminal_scan_match_jax(case):
    """A first rung too small to certify forces the later rungs and the
    terminal exact scan; both packages must agree on every output."""
    q2, err_r, scale2, table = _cert_inputs(case)
    n_valid = case["peng"].n_valid
    rungs = (1, 2, 4)
    jd, jr, jok, jok1 = jfused.fused_select_esc(
        jnp.asarray(case["jmins"]), jnp.asarray(q2.numpy()),
        jnp.asarray(table), jnp.asarray(case["jecho"]), jnp.int32(n_valid),
        TOPK, rungs, 1, err_r=jnp.asarray(err_r.numpy()),
        scale2=jnp.float32(scale2), final_exact=True)
    d, r, ok, ok1 = pfused.fused_select_esc(
        torch.from_numpy(case["jmins"]), q2, torch.from_numpy(table),
        torch.from_numpy(case["jecho"]), n_valid, TOPK, rungs, 1,
        err_r=err_r, scale2=scale2, final_exact=True)
    assert not bool(ok1.all())                 # the ladder did run
    assert np.array_equal(ok1.numpy(), np.asarray(jok1))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert np.array_equal(d.numpy(), np.asarray(jd))
    scan_codes = case["jecho"][:n_valid]
    assert_ids_carry_dists(table, scan_codes, d.numpy(), r.numpy())
    assert_ids_up_to_ties(table, scan_codes, r.numpy(), np.asarray(jr),
                          TOPK)


@pytest.mark.parametrize("rungs", [(1, 2, 4), (3, 24), (40,)])
def test_per_query_ladder_matches_batch_ladder(case, rungs):
    """The per-query ladder's plain version against the batch ladder on
    the same certificate inputs: the same rows certify at rung 1 and at
    the end (the fixtures' unit counts take ``_select_units``'s exact
    branch, so both fences are exact), and every row that either
    certifies has the same distances; the wrapper's buffer holds the same
    results, and a CPU call launches nothing."""
    q2, err_r, scale2, table = _cert_inputs(case)
    n_valid = case["peng"].n_valid
    mins = torch.from_numpy(case["jmins"])
    echo = torch.from_numpy(case["jecho"])
    table = torch.from_numpy(table)
    mins_bn = fk.pool_mins_nb(mins, 1) * scale2
    d, ids, status = fk.fused_ladder_ref(mins_bn, q2, table, echo, n_valid,
                                         TOPK, rungs, 1, err_r=err_r)
    bd, br, bok, bok1 = pfused.fused_select_esc(
        mins, q2, table, echo, n_valid, TOPK, rungs, 1, err_r=err_r,
        scale2=scale2, final_exact=False)
    ok = status != fk.LADDER_FAILED
    assert torch.equal(status == 0, bok1)
    assert torch.equal(ok, bok)
    both = ok | bok
    assert bool(both.any())
    assert torch.equal(d[both], bd[both])
    scan_codes = case["jecho"][:n_valid]
    assert_ids_carry_dists(table[ok].numpy(), scan_codes, d[ok].numpy(),
                           ids[ok].numpy())
    assert_ids_up_to_ties(table[ok].numpy(), scan_codes, ids[ok].numpy(),
                          br[ok].numpy(), TOPK)
    before = build.launch_counts()
    buf = fk.fused_ladder(mins_bn, q2, table, echo, n_valid, TOPK, rungs,
                          1, err_r=err_r)
    assert build.launch_counts() == before
    for got, want in zip(fk.ladder_views(buf, len(d), TOPK),
                         (d, ids, status)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("NU,n_sub", [(20000, 16), (33000, 40), (900, 7)])
def test_select_units_matches_jax(NU, n_sub):
    """Both branches: flat top-k (NU <= 16384) and two-level."""
    mins = np.random.default_rng(NU).normal(size=(4, NU)).astype(np.float32)
    js, jf = jfp._select_units(jnp.asarray(mins), n_sub)
    s, f = fk._select_units(torch.from_numpy(mins), n_sub)
    assert np.array_equal(np.sort(s.numpy(), 1), np.sort(np.asarray(js), 1))
    assert np.array_equal(f.numpy(), np.asarray(jf))


def test_engine_matches_jax_engine(case):
    jeng, peng, queries = case["jeng"], case["peng"], case["queries"]
    jd, ji = jeng.query(queries, top_k=TOPK)
    d, i = peng.query(queries, top_k=TOPK)
    # table ulps differ between the frameworks' f32 matmuls
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)
    codes = case["codes"]
    table = peng.prepare(queries)[0][:len(queries)]
    assert_ids_up_to_ties(table.numpy(), codes, i, ji, TOPK)
    # bit-equal to the port's own exact scan over the same table
    dr, ir = adc_query_topk(table, torch.from_numpy(pad_codes(codes, 1024)),
                            len(codes), TOPK, 1024)
    assert np.array_equal(d, dr.numpy())
    assert_ids_carry_dists(table.numpy(), codes, d, i)
    assert 0.0 <= peng.last_exact_frac <= 1.0


def test_engine_save_load_keeps_precision(case, tmp_path):
    peng, queries = case["peng"], case["queries"]
    path = str(tmp_path / "port_engine")
    peng.save(path)
    with np.load(path + ".npz") as z:
        assert str(z["precision"]) == "int16"
        state = dict(z)
    back = FusedCompressedEngine.load(path, device=CPU)
    assert back.precision == "int16"
    for name in ("row_data", "vals", "meta"):
        assert np.array_equal(getattr(back.tiles, name),
                              getattr(peng.tiles, name))
    d0, i0 = peng.query(queries, top_k=TOPK)
    d1, i1 = back.query(queries, top_k=TOPK)
    assert np.array_equal(d0, d1) and np.array_equal(i0, i1)
    # a saved precision is honoured, not rebuilt as int16
    for prec, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        state["precision"] = np.array(prec)
        np.savez(str(tmp_path / f"{prec}_engine"), **state)
        back2 = FusedCompressedEngine.load(str(tmp_path / f"{prec}_engine"),
                                           device=CPU)
        assert back2.precision == prec
        assert back2.cwbd.dtype == dtype
        d2, _ = back2.query(queries, top_k=TOPK)
        assert np.array_equal(d2, d0)          # exact in every precision
    # ... and one the port lacks raises
    state["precision"] = np.array("fp8")
    with pytest.raises(NotImplementedError):
        engine_state_from_numpy(state, device=CPU)


def test_engine_from_tree_and_warmup(case):
    M, K, codes, cw = case["M"], case["K"], case["codes"], case["cw"]
    res = find_edges_by_diff(codes, K=K, method=1)
    tree = build_layout(codes, res.edges, res.root_id, K=K, tables="skip")
    eng = FusedCompressedEngine.from_tree(cw, tree, device=CPU)
    assert np.array_equal(decode_stream_tiles(eng.tiles),
                          codes[tree.vec_id.astype(np.int64)])
    assert eng.bytes_per_vec() < M       # compressed below plain codes
    assert eng.bytes_per_vec() == \
        build_stream_tiles(codes[tree.vec_id.astype(np.int64)]
                           ).bytes_per_vec()
    eng.warmup(batch_sizes=(B,), top_k=TOPK)
    assert 0.0 <= eng.last_exact_frac <= 1.0
    d, i = eng.query(case["queries"], top_k=TOPK)
    dr, _ = case["peng"].query(case["queries"], top_k=TOPK)
    assert np.array_equal(d, dr)


def test_unported_modes_raise(case):
    """Every precision and tile format of the JAX package is ported; an
    unknown one, a scan mode its operands do not match, more than two
    subspace groups and the pipelined kernel outside its modes raise."""
    cw, codes = case["cw"], case["codes"]
    with pytest.raises(NotImplementedError):
        FusedCompressedEngine(cw, codes, precision="fp8", device=CPU)
    with pytest.raises(ValueError):
        FusedCompressedEngine(cw, codes, fmt="v3", device=CPU)
    peng = case["peng"]
    qop = torch.from_numpy(case["qop"])
    args = (peng.cwbd, peng.row_data, peng.vals, peng.meta, peng.n_valid)
    # mixed operand types (bf16 queries, int8 codebook); int16 operands
    # in the bf16 mode; an unknown mode
    with pytest.raises(ValueError):
        fk.fused_stream_mins(qop.to(torch.bfloat16), *args, case["M"],
                             mode="int16")
    with pytest.raises(ValueError):
        fk.fused_stream_mins(qop, *args, case["M"], mode="bf16")
    with pytest.raises(NotImplementedError):
        fk.fused_stream_mins(qop, *args, case["M"], mode="int4")
    # more than two subspace groups; the pipelined kernel at int16 (the
    # JAX package takes its serial kernel there without a word)
    with pytest.raises(NotImplementedError):
        fk.fused_stream_mins(qop, *args, 17, mode="int16")
    with pytest.raises(NotImplementedError):
        fk.fused_stream_mins(qop, *args, case["M"], mode="int16",
                             pipelined=True)
    with pytest.raises(NotImplementedError):
        FusedCompressedEngine(cw, codes, precision="int16", pipelined=True,
                              device=CPU)


def test_calibrate_grows_a_too_small_first_rung(case):
    """A first rung of one unit rarely certifies; calibration must grow
    ``ns_hint`` and the results stay exact."""
    peng = case["peng"]
    eng = FusedCompressedEngine.from_tiles(case["cw"], peng.tiles,
                                           row_to_db=case["order"], device=CPU)
    eng.ns_hint = 1
    eng.calibrate(top_k=TOPK)
    assert eng.ns_hint > 1
    d, _ = eng.query(case["queries"], top_k=TOPK)
    dr, _ = peng.query(case["queries"], top_k=TOPK)
    assert np.array_equal(d, dr)



def _parent_rungs(ns_total, top_k, b_cols, first):
    """The ladder's sizing as the engines derived it before ``rung_plan``:
    pool, units, first rung (``n_sub or ns_hint or _default_n_sub``) and
    the rungs (ns, 2ns, 8ns, cap), written out."""
    pool = (1 if ns_total <= 32768 else 2 if ns_total <= 131072
            else 4 if ns_total <= 1048576 else 8)
    n_units = -(-ns_total // pool)
    unit = 32 * pool
    top = max(n_units - 1, 1)
    want = -(-max(50 * top_k, 512) // unit)
    ns = min(first or int(max(2, min(want, top))), top)
    cap_rows = max(8192, 65536 * 512 // max(b_cols, 512))
    ns_cap = min(top, max(ns, cap_rows // unit))
    rungs = tuple(dict.fromkeys(
        [ns, min(ns * 2, ns_cap), min(ns * 8, ns_cap), ns_cap]))
    return pool, n_units, rungs


@pytest.mark.parametrize("ns_total", [1, 32, 32768, 32769, 131073, 1048577])
@pytest.mark.parametrize("top_k", [1, 10, 100, 128])
def test_rung_plan_is_the_parents_recipe(ns_total, top_k):
    """``rung_plan`` gives the integers the engines, the sharded step,
    ``entry`` and the tools each derived for themselves before: across
    the pool boundaries, the batch widths that shrink the cap rung, and a
    first rung of the default, of one unit and above the cap."""
    assert fk.SUB == 32                 # the recipe's subtile rows
    for b_cols in (128, 512, 1024, 4096):
        cap = _parent_rungs(ns_total, top_k, b_cols, None)[2][-1]
        for first in (None, 1, cap + 5):
            plan = pfused.rung_plan(ns_total, top_k, b_cols, first)
            want = _parent_rungs(ns_total, top_k, b_cols, first)
            assert tuple(plan) == want, (b_cols, first)
            assert plan.rungs == tuple(sorted(set(plan.rungs)))


def test_calibrate_hint_sequence_is_the_parents(case):
    """The forced case of ``test_calibrate_grows_a_too_small_first_rung``
    walks the first rungs it walked before the growth rule moved into
    ``grow_hint``: the hint each calibration round starts from, then the
    last one."""
    peng = case["peng"]
    eng = FusedCompressedEngine.from_tiles(case["cw"], peng.tiles,
                                           row_to_db=case["order"], device=CPU)
    eng.ns_hint = 1
    seen = []
    query = eng.query

    def traced(*a, **k):
        seen.append(eng.ns_hint)
        return query(*a, **k)

    eng.query = traced
    eng.calibrate(top_k=TOPK)
    seen.append(eng.ns_hint)
    parent = {(4, 32): [1, 2, 4, 8, 8], (8, 256): [1, 2, 4, 8, 8],
              (16, 16): [1, 2, 4, 8, 16, 16]}
    assert seen == parent[case["M"], case["K"]]


def test_calibrate_cap_is_the_parents_at_b128():
    """``calibrate`` takes its cap from ``rung_plan`` at its b=128: the
    fixed 65,536 rows it used before, at every pool."""
    for ns_total in (188, 32768, 32769, 131073, 1048577):
        pool, n_units, _ = pfused.rung_plan(ns_total, TOPK, 128)
        unit = fk.SUB * pool
        for first in (1, 7, 2048, 10 ** 6):
            rungs = pfused.rung_plan(ns_total, TOPK, 128, first).rungs
            assert rungs[-1] == min(max(n_units - 1, 1),
                                    max(rungs[0], 65536 // unit))
