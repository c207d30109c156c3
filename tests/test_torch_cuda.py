"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.

This file imports no jax, so on a GPU host without jax it runs as
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from deltapq_tpu_torch.bigscale import ChunkedCompressedEngine
from deltapq_tpu_torch.kernels import build
from deltapq_tpu_torch.ops import fused as pfused
from deltapq_tpu_torch.ops import fused_kernels as fk
from deltapq_tpu_torch.ops.adc import adc_query_topk, adc_table, pad_codes
from deltapq_tpu_torch.ops.delta_tiles import decode_delta_tiles
from deltapq_tpu_torch.ops.fused import FusedCompressedEngine
from deltapq_tpu_torch.ops.stream_tiles import decode_stream_tiles

from _torch_port import (ADC_TOPK_CASES, adc_topk_case, adc_topk_tiles_model,
                         tile_dict_codes)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _codes(rng, n, M, K):
    """Delta-compressible codes: repeated rows + sparse flips."""
    base = rng.integers(0, K, size=(n, M))
    codes = np.repeat(base, rng.integers(1, 6, size=n), axis=0)[:n]
    flip = rng.random(codes.shape) < 0.15
    return np.where(flip, rng.integers(0, K, codes.shape), codes
                    ).astype(np.uint8)


def _engine(rng, n, M, K, Ds, device):
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    return FusedCompressedEngine(cw, _codes(rng, n, M, K), device=device)


@pytest.mark.parametrize("n,M,K,Ds,B", [(9000, 8, 256, 16, 200),
                                        (3000, 4, 32, 4, 128),
                                        (5000, 8, 64, 8, 70)])
def test_stream_kernel_matches_plain(cuda, n, M, K, Ds, B):
    rng = np.random.default_rng(n)
    eng = _engine(rng, n, M, K, Ds, cuda)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    table, qop, uq, cert, b = eng.prepare(q)
    before = build.launch_counts()["stream_mins"]
    mins, codes = eng.scan(qop, uq)
    torch.cuda.synchronize()
    assert build.launch_counts()["stream_mins"] == before + 1
    ref_m, ref_c, pre_max, cross_max = fk.fused_stream_mins_ref(
        qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid,
        M, u=uq, mode="int16")
    assert torch.equal(codes, ref_c)
    tol = 4e-6 * (pre_max + 2 * cross_max)
    fin = torch.isfinite(ref_m)
    assert torch.equal(fin, torch.isfinite(mins))
    assert float((mins[fin] - ref_m[fin]).abs().max()) <= tol


@pytest.mark.parametrize("B,M,K,S", [(64, 8, 256, 5000), (8, 4, 32, 65536),
                                     (3, 8, 16, 1), (16, 8, 512, 3000)])
def test_rerank_kernel_bit_equal(cuda, B, M, K, S):
    """u8 candidate codes, and int32 ones for K > 256."""
    g = torch.Generator(device=cuda).manual_seed(S)
    tab = torch.randn((B, M * K), generator=g, device=cuda) * 100
    cand = torch.randint(0, K, (B, M, S), generator=g, device=cuda,
                         dtype=torch.uint8 if K <= 256 else torch.int32)
    out = fk.rerank_table_sums(tab, cand)
    assert torch.equal(out, fk.rerank_table_sums_ref(tab, cand))


def test_engine_exact_on_card(cuda):
    rng = np.random.default_rng(5)
    n, M, K, Ds = 20000, 8, 256, 16
    eng = _engine(rng, n, M, K, Ds, cuda)
    q = rng.normal(size=(300, M * Ds)).astype(np.float32) * 3
    build.reset_launch_counts()
    d, i = eng.query(q, top_k=10)
    counts = build.launch_counts()
    assert counts["stream_mins"] == 1 and counts["ladder"] == 1
    table = eng.prepare(q)[0][:len(q)]     # the engine's own table
    codes = torch.from_numpy(pad_codes(decode_stream_tiles(eng.tiles),
                                       1024))
    dr, _ = adc_query_topk(table, codes.to(cuda), n, 10, 1024)
    assert np.array_equal(d, dr.cpu().numpy())


def _own_dists(table, codes, rows):
    """Each row's exact distance, summed in ascending m from 0.0."""
    c = codes[rows.clamp_min(0)].to(torch.int64)            # [B, k, M]
    bi = torch.arange(table.shape[0], device=table.device)[:, None]
    own = torch.zeros(rows.shape, dtype=torch.float32, device=table.device)
    for m in range(table.shape[1]):
        own = own + table[bi, m, c[:, :, m]]
    return own


def test_ladder_and_terminal_scan_on_card(cuda):
    """Rungs of 1, 2 and 4 units cannot certify a top-10, so the later
    rungs and the terminal exact scan run on the card; the distances stay
    bit-equal to the plain exact scan.  The engine with a one-unit first
    rung takes the same ladder (ns, 2ns, 8ns, cap) through ``query``."""
    rng = np.random.default_rng(11)
    n, M, K, Ds = 20000, 8, 256, 16
    eng = _engine(rng, n, M, K, Ds, cuda)
    q = rng.normal(size=(256, M * Ds)).astype(np.float32) * 3
    table, qop, uq, (q2, err_r, scale2), b = eng.prepare(q)
    mins, echo = eng.scan(qop, uq)
    build.reset_launch_counts()
    d, rows, ok, ok1 = pfused.fused_select_esc(
        mins, q2, table, echo, eng.n_valid, 10, (1, 2, 4), 1,
        err_r=err_r, scale2=scale2, final_exact=True)
    assert build.launch_counts()["rerank"] == 3
    assert not bool(ok.all())                # the terminal scan ran
    dr, _ = adc_query_topk(table, echo, eng.n_valid, 10, 1024)
    assert torch.equal(d, dr)
    assert torch.equal(_own_dists(table, echo, rows), d)

    eng.ns_hint = 1
    de, _ = eng.query(q, top_k=10)
    assert eng.last_exact_frac < 1.0         # the first rung failed
    assert np.array_equal(de, dr[:b].cpu().numpy())


# ---- the per-query ladder (csrc/ladder.cu) ------------------------------

#: shape -> (N, M, K, Ds, B, top_k): SIFT1M's (pool 1), GIST1M's at the
#: benchmark's 250,000 rows (M=16, top-100; B=500 carries 12 padding
#: rows), and enough rows for pool 2
LADDER_SHAPES = {"sift": (1_000_000, 8, 256, 16, 512, 10),
                 "gist": (250_000, 16, 256, 60, 500, 100),
                 "pool2": (1_500_000, 8, 256, 16, 500, 10)}
_LADDER_DATA = {}


def _ladder_data(shape):
    """(codebook, codes, queries near the data) of a shape, made once."""
    if shape not in _LADDER_DATA:
        n, M, K, Ds, B, _ = LADDER_SHAPES[shape]
        rng = np.random.default_rng(n + M)
        cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
        codes = _codes(rng, n, M, K)
        rows = codes[rng.integers(0, n, B)]
        q = (np.concatenate([cw[m][rows[:, m]] for m in range(M)], 1)
             + rng.normal(size=(B, M * Ds)).astype(np.float32) * 2)
        _LADDER_DATA[shape] = cw, codes, q
    return _LADDER_DATA[shape]


def _assert_ids_up_to_ties(table, codes_db, d, ids, ids_ref):
    """-1 exactly at +inf; each id carries its distance; below each
    row's k-th distance the id sets are equal."""
    fin = torch.isfinite(d)
    assert torch.equal(ids < 0, ~fin)
    own = _own_dists(table, codes_db, ids)
    assert torch.equal(torch.where(fin, own, d), d)
    strict = d < d[:, -1:]
    a = torch.sort(torch.where(strict, ids, -2), dim=1).values
    b = torch.sort(torch.where(strict, ids_ref, -2), dim=1).values
    assert torch.equal(a, b)


@pytest.mark.parametrize("NS,B,pool,scaled", [(1000, 100, 1, False),
                                               (4096, 512, 2, True),
                                               (33, 7, 4, True),
                                               (31264, 512, 1, True)])
def test_ladder_mins_kernel_bit_equal(cuda, NS, B, pool, scaled):
    """Pooled, laid out a query a row, scale2 folded in; ragged edges
    (NS not a multiple of the pool, B and units not of 32) pad with
    +inf as the plain version does."""
    g = torch.Generator(device=cuda).manual_seed(NS + B)
    mins = torch.randn((NS, B), generator=g, device=cuda) * 1e4
    mins[-3:] = float("inf")
    scale2 = (torch.tensor(0.37, device=cuda) if scaled else None)
    want = fk.pool_mins_nb(mins, pool)
    if scaled:
        want = want * scale2
    got = fk.ladder_mins(mins, pool, scale2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,precision,forced", [
    (shape, precision, forced)
    for shape in ("sift", "gist") for precision in ("bf16", "int8", "int16")
    for forced in (False, True)] + [("pool2", "bf16", False),
                                    ("pool2", "int8", True)])
def test_ladder_kernel_matches_plain(cuda, shape, precision, forced):
    """The ladder kernel against its plain version on a scan's own
    minima: distances bit-equal, status bytes equal, ids equal up to ties
    at equal distance (mapped through ``row_to_db``), one ``ladder``
    launch; certified rows equal the plain exact scan.  ``forced`` takes a
    one-unit first rung, so rows climb to 2, 8 and the cap's units (the
    cap selects again).  The engine's own query then runs the kernel once
    a batch, and B2 not at all, exactly."""
    n, M, K, Ds, B, top_k = LADDER_SHAPES[shape]
    cw, codes, q = _ladder_data(shape)
    order = np.lexsort(codes.T[::-1])
    eng = pfused.FusedCodesEngine(cw, codes, order=order,
                                  precision=precision, device=cuda)
    table, qop, uq, (q2, err_r, scale2), b = eng.prepare(q)
    assert b == B
    mins, echo = eng.scan(qop, uq)
    pool, n_units, rungs = pfused.rung_plan(mins.shape[0], top_k,
                                            table.shape[0],
                                            1 if forced else None)
    assert pool == (2 if shape == "pool2" else 1)
    assert fk.ladder_takes(table, echo, top_k, n_units, rungs)
    mins_bn = fk.pool_mins_nb(mins, pool)
    if scale2 is not None:
        mins_bn = mins_bn * scale2
    build.reset_launch_counts()
    assert torch.equal(fk.ladder_mins(mins, pool, scale2), mins_bn)
    assert build.launch_counts()["ladder_mins"] == 1
    buf = fk.fused_ladder(mins_bn, q2, table, echo, n, top_k, rungs, pool,
                          err_r=err_r, row_to_db=eng.row_to_db)
    torch.cuda.synchronize()
    assert build.launch_counts()["ladder"] == 1
    d, ids, status = fk.ladder_views(buf, table.shape[0], top_k)
    rd, rids, rstatus = fk.fused_ladder_ref(
        mins_bn, q2, table, echo, n, top_k, rungs, pool, err_r=err_r,
        row_to_db=eng.row_to_db)
    assert torch.equal(status, rstatus)
    assert torch.equal(d, rd)
    codes_db = torch.from_numpy(codes).to(cuda).to(torch.int64)
    _assert_ids_up_to_ties(table, codes_db, d, ids, rids)
    if forced:          # some rows climbed through every rung to the cap
        assert bool(((status == 3) | (status == fk.LADDER_FAILED)).any())
    dr, ir = adc_query_topk(table, eng.codes, n, top_k, 1024)
    ir = eng.row_to_db[ir].to(torch.int64)
    ok = status != fk.LADDER_FAILED
    assert forced or bool(ok[:b].any())
    assert torch.equal(d[ok], dr[ok])
    _assert_ids_up_to_ties(table[ok], codes_db, d[ok], ids[ok], ir[ok])

    if not forced:
        build.reset_launch_counts()
        de, ie = eng.query(q, top_k=top_k)
        torch.cuda.synchronize()
        counts = build.launch_counts()
        assert counts["ladder"] == 1 and counts["rerank"] == 0
        assert np.array_equal(de, dr[:b].cpu().numpy())
        _assert_ids_up_to_ties(table[:b], codes_db,
                               torch.from_numpy(de).to(cuda),
                               torch.from_numpy(ie).to(cuda), ir[:b])


# ---- the index tiers' kernels ------------------------------------------

def _bf16_tol(pre_max, cross_max):
    """f32 sums of exact bf16 products, in two orders: each side is off
    by at most ~D * 2^-24 of sum |terms| (D <= 128), and sum |x^ q| <=
    the cross bound; 2e-5 covers both sides."""
    return 2e-5 * (pre_max + 2 * cross_max)


def _assert_mins(mins, ref, tol):
    fin = torch.isfinite(ref)
    assert torch.equal(fin, torch.isfinite(mins))
    assert float((mins[fin] - ref[fin]).abs().max()) <= tol


@pytest.mark.parametrize("n,M,K,Ds,B", [(9000, 8, 256, 16, 200),
                                        (3000, 4, 32, 4, 128),
                                        (5000, 8, 64, 2, 70)])
def test_stream_kernel_bf16_matches_plain(cuda, n, M, K, Ds, B):
    rng = np.random.default_rng(n + 1)
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    eng = FusedCompressedEngine(cw, _codes(rng, n, M, K), precision="bf16",
                                device=cuda)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    table, qop, uq, cert, b = eng.prepare(q)
    assert qop.dtype == torch.bfloat16 and uq is None
    before = build.launch_counts()["stream_mins_bf16"]
    mins, codes = eng.scan(qop, uq)
    torch.cuda.synchronize()
    assert build.launch_counts()["stream_mins_bf16"] == before + 1
    ref_m, ref_c, pre_max, cross_max = fk.fused_stream_mins_ref(
        qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid, M,
        mode="bf16")
    assert torch.equal(codes, ref_c)
    _assert_mins(mins, ref_m, _bf16_tol(pre_max, cross_max))


@pytest.mark.parametrize("precision", ["bf16", "int16"])
@pytest.mark.parametrize("n,M,K,Ds,B", [(9000, 8, 256, 16, 200),
                                        (3000, 4, 32, 4, 64)])
def test_codes_kernel_matches_plain(cuda, precision, n, M, K, Ds, B):
    rng = np.random.default_rng(n + 2)
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    eng = pfused.FusedCodesEngine(cw, _codes(rng, n, M, K),
                                  precision=precision, device=cuda)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    table, qop, uq, cert, b = eng.prepare(q)
    key = "codes_mins" if precision == "bf16" else "codes_mins_int16"
    before = build.launch_counts()[key]
    mins, echo = eng.scan(qop, uq)
    torch.cuda.synchronize()
    assert build.launch_counts()[key] == before + 1
    assert echo is eng.codes
    ref_m, _, pre_max, cross_max = fk.fused_codes_mins_ref(
        qop, eng.cwbd, eng.codes, eng.n_valid, u=uq, mode=precision)
    tol = (_bf16_tol(pre_max, cross_max) if precision == "bf16"
           else 4e-6 * (pre_max + 2 * cross_max))
    _assert_mins(mins, ref_m, tol)


@pytest.mark.parametrize("n,M,K,Ds,B,tile", [(20000, 8, 256, 16, 200, 8192),
                                             (3000, 4, 16, 8, 64, 1024)])
def test_decoded_kernel_matches_plain(cuda, n, M, K, Ds, B, tile):
    rng = np.random.default_rng(n + 3)
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    eng = pfused.FusedDecodedEngine(cw, _codes(rng, n, M, K), tile=tile,
                                    device=cuda)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    table, qop, uq, cert, b = eng.prepare(q)
    before = build.launch_counts()["decoded_mins"]
    mins, _ = eng.scan(qop, uq)
    torch.cuda.synchronize()
    assert build.launch_counts()["decoded_mins"] == before + 1
    ref_m, pre_max, cross_max = fk.fused_decoded_mins_ref(qop, eng.xt, n)
    _assert_mins(mins, ref_m, _bf16_tol(pre_max, cross_max))


@pytest.mark.parametrize("B,M,K,n,tile,k", [(200, 8, 256, 20000, 4096, 10),
                                            (37, 4, 16, 3000, 1024, 7),
                                            (20, 8, 512, 9000, 4096, 10),
                                            (16, 8, 16, 300, 256, 40)])
def test_adc_topk_kernel_bit_equal(cuda, B, M, K, n, tile, k):
    """Padding rows, K > 256 (int32 codes), duplicate rows (ties) and a
    top_k beyond a tile's valid rows."""
    from deltapq_tpu_torch.ops import adc_kernels as ak

    rng = np.random.default_rng(n + k)
    table = torch.from_numpy(rng.normal(size=(B, M, K)).astype(np.float32)
                             ).to(cuda)
    dt = np.uint8 if K <= 256 else np.int32
    codes = torch.from_numpy(pad_codes(
        _codes(rng, n, M, min(K, 256)).astype(dt), tile)).to(cuda)
    if K > 256:
        codes[::3, 0] = 300
    before = build.launch_counts()["adc_topk"]
    d, i = ak.adc_topk_tiles(table, codes, n, k, tile)
    torch.cuda.synchronize()
    assert build.launch_counts()["adc_topk"] == before + 1
    rd, ri = ak.adc_topk_tiles_ref(table, codes, n, k, tile)
    assert torch.equal(d, rd) and torch.equal(i, ri)
    dm, _ = ak.adc_topk_pallas(table, codes, n, k, tile, "f32")
    dr, _ = adc_query_topk(table, pad_codes(codes, 1024), n, k, 1024)
    assert torch.equal(dm, dr)


@pytest.mark.parametrize("engine", ["fused", "fused_codes",
                                    "fused_compressed", "fused_dedup",
                                    "pallas", "auto"])
def test_index_search_on_card(cuda, engine):
    """One index search per engine on the card: distances bit-equal to
    the plain exact scan over the table the engine made."""
    from deltapq_tpu_torch.index import DeltaPQIndex
    from deltapq_tpu_torch.ops.adc import adc_table

    rng = np.random.default_rng(7)
    M, K, Ds, n = 8, 256, 16, 20000
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    codes = _codes(rng, n, M, K)
    idx = DeltaPQIndex(cw, codes, engine=engine, device=cuda)
    q = rng.normal(size=(300, M * Ds)).astype(np.float32) * 3
    build.reset_launch_counts()
    d, i = idx.search(q, top_k=10)
    counts = build.launch_counts()
    key = {"fused": "decoded_mins", "fused_codes": "codes_mins",
           "fused_compressed": "stream_mins_bf16",
           "pallas": "adc_topk"}.get(engine)     # auto: fused_dedup here
    if key:
        assert counts[key] >= 1, counts
    eng = idx._fused_engine
    # the fused tiers' own table (csrc/prepare.cu), else adc_table's
    table = (eng.prepare(q)[0][:len(q)] if hasattr(eng, "prepare") else
             adc_table(torch.from_numpy(cw).to(cuda),
                       torch.from_numpy(q).to(cuda)))
    dr, _ = adc_query_topk(table, torch.from_numpy(pad_codes(codes, 1024)
                                                   ).to(cuda), n, 10, 1024)
    assert np.array_equal(d, dr.cpu().numpy())
    assert torch.equal(_own_dists(table, torch.from_numpy(codes).to(cuda),
                                  torch.from_numpy(i).to(cuda)), dr)


# ---- int8 mode and the slot-tile kernel ----------------------------------

@pytest.mark.parametrize("n,M,K,Ds,B", [(9000, 8, 256, 16, 200),
                                        (3000, 4, 32, 4, 64),
                                        (5000, 8, 64, 8, 70)])
def test_int8_stream_and_codes_kernels_bit_equal(cuda, n, M, K, Ds, B):
    """B1 and B3 in int8 mode: every partial sum is an exact integer and
    the two roundings follow the plain version's order, so the mins are
    bit-equal; the echo is exact."""
    rng = np.random.default_rng(n + 4)
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    codes = _codes(rng, n, M, K)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    eng = FusedCompressedEngine(cw, codes, precision="int8", device=cuda)
    table, qop, uq, cert, b = eng.prepare(q)
    before = build.launch_counts()["stream_mins_int8"]
    mins, echo = eng.scan(qop, uq)
    torch.cuda.synchronize()
    assert build.launch_counts()["stream_mins_int8"] == before + 1
    ref_m, ref_c, _, _ = fk.fused_stream_mins_ref(
        qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid, M,
        u=uq, mode="int8")
    assert torch.equal(echo, ref_c) and torch.equal(mins, ref_m)
    ce = pfused.FusedCodesEngine(cw, codes, precision="int8", device=cuda)
    table, qop, uq, cert, b = ce.prepare(q)
    before = build.launch_counts()["codes_mins_int8"]
    mins, _ = ce.scan(qop, uq)
    torch.cuda.synchronize()
    assert build.launch_counts()["codes_mins_int8"] == before + 1
    ref_m, _, _, _ = fk.fused_codes_mins_ref(qop, ce.cwbd, ce.codes,
                                             ce.n_valid, u=uq, mode="int8")
    assert torch.equal(mins, ref_m)


@pytest.mark.parametrize("precision", ["int8", "int16", "bf16"])
@pytest.mark.parametrize("n,M,K,Ds,B,S", [(9000, 8, 256, 16, 200, None),
                                          (3000, 4, 32, 4, 64, 1),
                                          (5000, 8, 64, 8, 70, 7)])
def test_delta_kernel_matches_plain(cuda, precision, n, M, K, Ds, B, S):
    """B5 in each mode against its plain version: echo exact and equal to
    the codes, mins bit-equal (int8) or within the int16 / bf16 bounds."""
    rng = np.random.default_rng(n + 5)
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    codes = _codes(rng, n, M, K)
    eng = FusedCompressedEngine(cw, codes, precision=precision, fmt="slots",
                                S=S, device=cuda)
    assert S is None or eng.tiles.S == S
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    table, qop, uq, cert, b = eng.prepare(q)
    key = {"int16": "delta_mins", "int8": "delta_mins_int8",
           "bf16": "delta_mins_bf16"}[precision]
    before = build.launch_counts()[key]
    mins, echo = eng.scan(qop, uq)
    torch.cuda.synchronize()
    assert build.launch_counts()[key] == before + 1
    ref_m, ref_c, pre_max, cross_max = fk.fused_delta_mins_ref(
        qop, eng.cwbd, eng.row_data, eng.ovf, eng.n_valid, eng.tiles.S,
        u=uq, mode=precision)
    assert torch.equal(echo, ref_c)
    assert np.array_equal(echo[:n].cpu().numpy(),
                          decode_delta_tiles(eng.tiles))
    if precision == "int8":
        assert torch.equal(mins, ref_m)
    else:
        tol = (_bf16_tol(pre_max, cross_max) if precision == "bf16"
               else 4e-6 * (pre_max + 2 * cross_max))
        _assert_mins(mins, ref_m, tol)


@pytest.mark.parametrize("fmt,precision", [("stream", "int8"),
                                           ("slots", "int8"),
                                           ("slots", "int16")])
def test_int8_and_slot_engines_exact_on_card(cuda, fmt, precision):
    rng = np.random.default_rng(17)
    n, M, K, Ds = 20000, 8, 256, 16
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    eng = FusedCompressedEngine(cw, _codes(rng, n, M, K),
                                precision=precision, fmt=fmt, device=cuda)
    q = rng.normal(size=(300, M * Ds)).astype(np.float32) * 3
    d, i = eng.query(q, top_k=10)
    table = eng.prepare(q)[0][:len(q)]
    dec = (decode_stream_tiles(eng.tiles) if fmt == "stream" else
           decode_delta_tiles(eng.tiles))
    codes = torch.from_numpy(pad_codes(dec, 1024)).to(cuda)
    dr, _ = adc_query_topk(table, codes, n, 10, 1024)
    assert np.array_equal(d, dr.cpu().numpy())


def test_scan_mode_mismatch_raises_on_card(cuda):
    """Operands of one mode launched in another raise before any launch:
    int16 digits in the int8 mode (the compact codebook has the int16
    shape) and int8 operands with an int16 compact codebook."""
    rng = np.random.default_rng(23)
    n, M, K, Ds = 3000, 8, 256, 16
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    codes = _codes(rng, n, M, K)
    e16 = FusedCompressedEngine(cw, codes, precision="int16", device=cuda)
    e8 = FusedCompressedEngine(cw, codes, precision="int8", device=cuda)
    q = rng.normal(size=(64, M * Ds)).astype(np.float32)
    _, q16, u16, _, _ = e16.prepare(q)
    _, q8, u8, _, _ = e8.prepare(q)
    before = build.launch_counts()
    with pytest.raises(ValueError):
        fk.fused_stream_mins(q16, e16.cwbd, e16.row_data, e16.vals,
                             e16.meta, n, M, u=u16, compact=e16.compact,
                             mode="int8")
    with pytest.raises(ValueError):
        fk.fused_stream_mins(q8, e8.cwbd, e8.row_data, e8.vals, e8.meta,
                             n, M, u=u8, compact=e16.compact, mode="int8")
    with pytest.raises(ValueError):
        fk.fused_stream_mins(q8, e8.cwbd, e8.row_data, e8.vals, e8.meta,
                             n, M, u=u8, compact=e8.compact, mode="int16")
    assert build.launch_counts() == before


@pytest.mark.parametrize("resident", [True, False])
def test_chunked_engine_exact_on_card(cuda, resident, tmp_path):
    """Three int8 chunks, resident and uploaded per batch from a
    memory-mapped save: distances bit-equal to the plain exact scan."""
    rng = np.random.default_rng(29)
    n, M, K, Ds = 30000, 8, 256, 16
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    codes = _codes(rng, n, M, K)
    eng = ChunkedCompressedEngine(cw, codes, chunk_rows=10240,
                                  device=cuda)
    if not resident:
        eng.save(str(tmp_path / "chunks"))
        eng = ChunkedCompressedEngine.from_saved(str(tmp_path / "chunks"),
                                                 mmap=True, device=cuda)
    q = rng.normal(size=(128, M * Ds)).astype(np.float32) * 3
    build.reset_launch_counts()
    d, i = eng.query(q, top_k=10)
    assert build.launch_counts()["stream_mins_int8"] == 3
    assert (eng.last_upload_s > 0.0) != resident
    table = adc_table(torch.from_numpy(cw).to(cuda),
                      torch.from_numpy(q).to(cuda))
    dr, _ = adc_query_topk(table, torch.from_numpy(pad_codes(codes, 1024))
                           .to(cuda), n, 10, 1024)
    assert np.array_equal(d, dr.cpu().numpy())


# ---- the plain-scan kernel family (ops/adc_kernels.py) --------------------

ADC_SHAPES = [
    # B, M, K, n, tile, k
    (200, 8, 256, 20000, 4096, 10),
    (37, 4, 16, 3000, 1024, 7),         # B not a multiple of the queries
                                        # per block, n_valid inside a tile
    (20, 8, 512, 9000, 4096, 10),       # K > 256: int32 codes
    (16, 8, 16, 300, 256, 40)]          # top_k beyond a tile's valid rows


def _adc_problem(cuda, B, M, K, n, tile, k):
    rng = np.random.default_rng(n + k)
    table = torch.from_numpy(
        rng.normal(size=(B, M, K)).astype(np.float32) * 10).to(cuda)
    dt = np.uint8 if K <= 256 else np.int32
    codes = torch.from_numpy(pad_codes(
        _codes(rng, n, M, min(K, 256)).astype(dt), tile)).to(cuda)
    if K > 256:
        codes[::3, 0] = 300
    return table, codes


@pytest.mark.parametrize("precision", ["bf16", "bf16x2"])
@pytest.mark.parametrize("B,M,K,n,tile,k", ADC_SHAPES)
def test_adc_topk_kernel_bf16_modes_bit_equal(cuda, precision, B, M, K, n,
                                              tile, k):
    from deltapq_tpu_torch.ops import adc_kernels as ak

    table, codes = _adc_problem(cuda, B, M, K, n, tile, k)
    name = f"adc_topk_{precision}"
    before = build.launch_counts()[name]
    d, i = ak.adc_topk_tiles(table, codes, n, k, tile, precision)
    torch.cuda.synchronize()
    assert build.launch_counts()[name] == before + 1
    rd, ri = ak.adc_topk_tiles_ref(table, codes, n, k, tile, precision)
    assert torch.equal(d, rd) and torch.equal(i, ri)


@pytest.mark.parametrize("B,M,K,n,tile", [(200, 8, 256, 20480, 512),
                                          (37, 4, 16, 3000, 8),
                                          (20, 8, 512, 9000, 8),
                                          (5, 32, 16, 1000, 8),
                                          (512, 8, 256, 25576, 8),
                                          (1, 8, 256, 20000, 8),
                                          (3, 8, 256, 1001, 1),
                                          (20, 16, 256, 5000, 8)])
def test_adc_dists_kernel_bit_equal(cuda, B, M, K, n, tile):
    """Rows that are no multiple of a block's (8,192) or of a lane's run,
    int32 codes, M beyond the codes a lane loads at once (4, 8, 16), the
    main shape's 512 queries, one query, N no multiple of 4 (stores of one
    float), and M=16, whose tables leave room for 8 queries a block."""
    from deltapq_tpu_torch.ops import adc_kernels as ak

    table, codes = _adc_problem(cuda, B, M, K, n, tile, 0)
    before = build.launch_counts()["adc_dists"]
    d = ak.adc_dists_pallas(table, codes, tile)
    torch.cuda.synchronize()
    assert build.launch_counts()["adc_dists"] == before + 1
    assert d.shape == (B, codes.shape[0])
    assert torch.equal(d, ak.adc_dists_ref(table, codes))


PACKED_SHAPES = ADC_SHAPES + [
    (9, 8, 64, 5000, 192, 12),          # a tile that is no multiple of 32
    (24, 4, 64, 5000, 1024, 300),       # top_k above one launch's 256 ranks
    (51, 8, 64, 10000, 2048, 10)]       # B no multiple of a block's queries


@pytest.mark.parametrize("precision,B,M,K,n,tile,k", [
    (p, *shape) for shape in PACKED_SHAPES
    for p in ("f32", "bf16", "bf16x2")] + [
    ("bf16", 20, 8, 8192, 3000, 1024, 10)])  # M*K above 49,152: one query
                                              # a warp, 2-byte table groups
def test_adc_topk_packed_kernel_bit_equal(cuda, precision, B, M, K, n, tile,
                                          k):
    from deltapq_tpu_torch.ops import adc_kernels as ak

    table, codes = _adc_problem(cuda, B, M, K, n, tile, k)
    name = ak._mode_name("adc_topk_packed", precision)
    before = build.launch_counts()[name]
    keys = ak.adc_topk_packed_tiles(table, codes, n, k, tile, precision)
    torch.cuda.synchronize()
    assert build.launch_counts()[name] == before + 1
    assert torch.equal(keys, ak.adc_topk_packed_tiles_ref(
        table, codes, n, k, tile, precision))
    d, i = ak.adc_topk_packed(table, codes, n, k, tile, precision)
    dc, ic = ak.adc_topk_packed(table.cpu(), codes.cpu(), n, k, tile,
                                precision)
    assert torch.equal(d.cpu(), dc) and torch.equal(i.cpu(), ic)


@pytest.mark.parametrize("B,M,K,n,tile,k,pool", [
    (200, 8, 256, 20000, 2048, 10, 24),
    (37, 4, 64, 3000, 256, 7, 24),      # n_valid inside a tile
    (130, 8, 256, 9000, 4096, 10, 200),  # a wide dictionary (max_dict 256)
    (16, 4, 64, 300, 256, 60, 8)])      # top_k beyond the valid rows
def test_adc_topk_tiledict_kernel_bit_equal(cuda, B, M, K, n, tile, k, pool):
    from deltapq_tpu_torch.ops import adc_kernels as ak

    rng = np.random.default_rng(n + k)
    table = torch.from_numpy(
        rng.normal(size=(B, M, K)).astype(np.float32) * 10).to(cuda)
    base = rng.integers(0, K, size=(pool, M))
    codes = base[rng.integers(0, pool, n)]
    flip = rng.random(codes.shape) < 0.01
    codes = np.where(flip, rng.integers(0, K, codes.shape), codes).astype(
        np.uint8)
    codes = pad_codes(codes[np.lexsort(codes.T[::-1])], tile)
    dicts, idx, width = ak.build_tile_dict(codes, tile_n=tile, max_dict=256)
    idx_d, dicts_d = (torch.from_numpy(a).to(cuda) for a in (idx, dicts))
    codes_d = torch.from_numpy(codes).to(cuda)
    before = build.launch_counts()["adc_topk_tiledict"]
    keys = ak.adc_topk_tiledict_tiles(table, idx_d, dicts_d, n, k, tile)
    torch.cuda.synchronize()
    assert build.launch_counts()["adc_topk_tiledict"] == before + 1
    assert torch.equal(keys, ak.adc_topk_tiledict_tiles_ref(
        table, idx_d, dicts_d, n, k, tile))
    # both stages select exact f32 values: the packed kernel's f32 keys
    assert torch.equal(keys, ak.adc_topk_packed_tiles(
        table, codes_d, n, k, tile, "f32"))
    d, i = ak.adc_topk_tiledict(table, idx_d, dicts_d, codes_d, n, k, tile)
    dp, ip = ak.adc_topk_packed(table, codes_d, n, k, tile, "f32")
    assert torch.equal(d, dp) and torch.equal(i, ip)


@pytest.mark.parametrize("B,M,K,width,n,tile,k", [
    (512, 8, 256, 32, 20000, 2048, 10),   # the dup_heavy shape; n_valid
                                          # inside the last tile
    (37, 4, 64, 8, 3000, 256, 1),
    (1, 16, 256, 64, 9000, 4096, 100),
    (37, 8, 256, 256, 10000, 2048, 300),  # top_k above one launch's ranks
    (512, 16, 256, 32, 5000, 1000, 10),   # a tile no multiple of 32 rows
    (1, 8, 256, 256, 5000, 256, 10),
    (37, 16, 64, 8, 12288, 4096, 300),
    (512, 4, 256, 64, 7000, 2048, 100)])
def test_adc_topk_tiledict_kernel_widths(cuda, B, M, K, width, n, tile, k):
    """B10 at dictionary widths 8-256 (its compact tables, 4*M*D bytes a
    warp, from 128 B to 16 KB): one launch, bit-equal to the plain version
    and to B9's f32 keys on the codes of the same rows."""
    from deltapq_tpu_torch.ops import adc_kernels as ak

    rng = np.random.default_rng(n + width)
    table = torch.from_numpy(
        rng.normal(size=(B, M, K)).astype(np.float32) * 10).to(cuda)
    codes = pad_codes(tile_dict_codes(rng, n, M, K, width), tile)
    dicts, idx, D = ak.build_tile_dict(codes, tile_n=tile, max_dict=256)
    assert D == width
    idx_d, dicts_d = (torch.from_numpy(a).to(cuda) for a in (idx, dicts))
    before = build.launch_counts()["adc_topk_tiledict"]
    keys = ak.adc_topk_tiledict_tiles(table, idx_d, dicts_d, n, k, tile)
    torch.cuda.synchronize()
    assert build.launch_counts()["adc_topk_tiledict"] == before + 1
    assert torch.equal(keys, ak.adc_topk_tiledict_tiles_ref(
        table, idx_d, dicts_d, n, k, tile))
    assert torch.equal(keys, ak.adc_topk_packed_tiles(
        table, torch.from_numpy(codes).to(cuda), n, k, tile, "f32"))


def test_plain_scan_engines_on_card(cuda):
    """TileDictEngine and DecodedEngine with the default device (the
    card), held to the plain exact scan."""
    from deltapq_tpu_torch.ops import adc_kernels as ak
    from deltapq_tpu_torch.ops.decoded import DecodedEngine

    rng = np.random.default_rng(11)
    M, K, Ds, n = 8, 256, 16, 30000
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    base = rng.integers(0, K, size=(40, M))
    codes = base[rng.integers(0, 40, n)].astype(np.uint8)
    order = np.lexsort(codes.T[::-1])
    q = rng.normal(size=(100, M * Ds)).astype(np.float32) * 3
    table = adc_table(torch.from_numpy(cw).to(cuda),
                      torch.from_numpy(q).to(cuda))
    dr, _ = adc_query_topk(table, torch.from_numpy(pad_codes(codes, 1024)
                                                   ).to(cuda), n, 10, 1024)
    eng = ak.TileDictEngine(cw, codes, order=order)
    assert eng.ok and eng.device.type == "cuda"
    build.reset_launch_counts()
    d, i = eng.query(q, top_k=10)
    assert build.launch_counts()["adc_topk_tiledict"] == 1
    own = ak._exact_dists_for_ids(table, torch.from_numpy(codes).to(cuda),
                                  torch.from_numpy(i).to(cuda))
    assert np.array_equal(own.cpu().numpy(), d)
    np.testing.assert_allclose(np.sort(d, axis=1), dr.cpu().numpy(),
                               rtol=2e-3)
    dec = DecodedEngine(cw, codes)
    assert dec.device.type == "cuda"
    dd, _ = dec.query(q, top_k=10)
    assert np.array_equal(dd, dr.cpu().numpy())


# ---- two subspace groups, two mask planes, D > 128 -------------------------

def _chain_codes(rng, n, M, K):
    """Each row differs from the one above in one or two subspaces, so
    stream and slot tiles compress."""
    codes = np.empty((n, M), np.uint8)
    codes[0] = rng.integers(0, K, size=M)
    for i in range(1, n):
        codes[i] = codes[i - 1]
        for _ in range(rng.integers(1, 3)):
            codes[i, rng.integers(0, M)] = rng.integers(0, K)
    return codes


#: (M, K, Ds): two groups at D=64, the GIST width D=960, one group of 8
#: subspaces wider than 128 dims, and an odd split (two groups of 6)
WIDE_SHAPES = [(16, 16, 4), (16, 64, 60), (8, 32, 24), (12, 32, 8)]


def _wide_tol(precision, pre_max, cross_max):
    return (_bf16_tol(pre_max, cross_max) if precision == "bf16"
            else 4e-6 * (pre_max + 2 * cross_max))


@pytest.mark.parametrize("precision", ["int16", "int8", "bf16"])
@pytest.mark.parametrize("M,K,Ds", WIDE_SHAPES)
@pytest.mark.parametrize("fmt", ["stream", "slots"])
def test_wide_tile_kernels_match_plain(cuda, fmt, M, K, Ds, precision):
    """B1 and B5 beyond one group: codes exact, int8 mins bit-equal, int16
    and bf16 within their bounds; B rows that do not fill a query block
    and an n_valid inside the last tile."""
    rng = np.random.default_rng(M * 100 + Ds)
    n, B = 2500, 70
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    codes = _chain_codes(rng, n, M, K)
    eng = FusedCompressedEngine(cw, codes, precision=precision, fmt=fmt,
                                device=cuda)
    assert eng.row_data.shape[1] == (M + 7) // 8 + (
        eng.tiles.S if fmt == "slots" else 0)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    table, qop, uq, cert, b = eng.prepare(q)
    key = fk._launch_name("stream_mins" if fmt == "stream" else "delta_mins",
                          precision)
    before = build.launch_counts()[key]
    mins, echo = eng.scan(qop, uq)
    torch.cuda.synchronize()
    assert build.launch_counts()[key] == before + 1
    if fmt == "stream":
        ref_m, ref_c, pre_max, cross_max = fk.fused_stream_mins_ref(
            qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid, M,
            u=uq, mode=precision)
    else:
        ref_m, ref_c, pre_max, cross_max = fk.fused_delta_mins_ref(
            qop, eng.cwbd, eng.row_data, eng.ovf, eng.n_valid, eng.tiles.S,
            u=uq, mode=precision)
    assert torch.equal(echo, ref_c)
    assert np.array_equal(echo[:n].cpu().numpy(), codes)
    if precision == "int8":
        assert torch.equal(mins, ref_m)
    else:
        _assert_mins(mins, ref_m, _wide_tol(precision, pre_max, cross_max))


@pytest.mark.parametrize("precision", ["int16", "int8", "bf16"])
@pytest.mark.parametrize("M,K,Ds", WIDE_SHAPES)
def test_wide_codes_kernel_matches_plain(cuda, M, K, Ds, precision):
    rng = np.random.default_rng(M * 100 + Ds + 1)
    n, B = 2500, 70
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    eng = pfused.FusedCodesEngine(cw, _codes(rng, n, M, K),
                                  precision=precision, device=cuda)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    table, qop, uq, cert, b = eng.prepare(q)
    key = fk._launch_name("codes_mins", precision)
    before = build.launch_counts()[key]
    mins, _ = eng.scan(qop, uq)
    torch.cuda.synchronize()
    assert build.launch_counts()[key] == before + 1
    ref_m, _, pre_max, cross_max = fk.fused_codes_mins_ref(
        qop, eng.cwbd, eng.codes, eng.n_valid, u=uq, mode=precision)
    if precision == "int8":
        assert torch.equal(mins, ref_m)
    else:
        _assert_mins(mins, ref_m, _wide_tol(precision, pre_max, cross_max))


@pytest.mark.parametrize("M,K,Ds,tile", [(16, 16, 4, 1024),
                                         (16, 64, 60, 8192),
                                         (8, 32, 24, 2048)])
def test_wide_decoded_kernel_matches_plain(cuda, M, K, Ds, tile):
    """B4 at D=64, at the GIST width (960 padded to 1024) and at D=192
    (padded to 256)."""
    rng = np.random.default_rng(M * 100 + Ds + 2)
    n, B = 2500, 70
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    eng = pfused.FusedDecodedEngine(cw, _codes(rng, n, M, K), tile=tile,
                                    device=cuda)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    table, qop, uq, cert, b = eng.prepare(q)
    before = build.launch_counts()["decoded_mins"]
    mins, _ = eng.scan(qop, uq)
    torch.cuda.synchronize()
    assert build.launch_counts()["decoded_mins"] == before + 1
    ref_m, pre_max, cross_max = fk.fused_decoded_mins_ref(qop, eng.xt, n)
    _assert_mins(mins, ref_m, _bf16_tol(pre_max, cross_max))


@pytest.mark.parametrize("engine", ["fused", "fused_codes",
                                    "fused_compressed", "auto"])
def test_index_m16_top100_on_card(cuda, engine):
    """The GIST-shaped index (M=16, Ds=60, top-100): auto resolves to the
    compressed tier and runs; distances bit-equal to the exact scan."""
    from deltapq_tpu_torch.index import DeltaPQIndex

    rng = np.random.default_rng(16)
    M, K, Ds, n = 16, 256, 60, 70000
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    codes = _chain_codes(rng, n, M, K)
    idx = DeltaPQIndex(cw, codes, engine=engine, device=cuda,
                       build_tree=False)
    q = rng.normal(size=(40, M * Ds)).astype(np.float32)
    d, i = idx.search(q, top_k=100)
    if engine == "auto":
        assert idx._engine_resolved == "fused_compressed"
    # the engine's own table: the f32 table product rounds by batch shape
    table = idx._fused_engine.prepare(q)[0][:len(q)]
    dr, _ = adc_query_topk(table, torch.from_numpy(pad_codes(codes, 1024)
                                                   ).to(cuda), n, 100, 1024)
    assert np.array_equal(d, dr.cpu().numpy())
    assert torch.equal(_own_dists(table, torch.from_numpy(codes).to(cuda),
                                  torch.from_numpy(i).to(cuda)), dr)


# ---- the pipelined stream kernel -----------------------------------------

@pytest.mark.parametrize("precision", ["int8", "bf16"])
@pytest.mark.parametrize("n,M,K,Ds,B", [(9000, 8, 256, 16, 200),
                                        (3000, 4, 32, 4, 64),
                                        (300000, 8, 64, 8, 454),
                                        (1000, 8, 16, 4, 5)])
def test_pipelined_stream_kernel_equals_stream_kernel(cuda, precision, n, M,
                                                      K, Ds, B):
    """B7 against B1 (codes equal; mins bit for bit in both modes: the
    two run one tail) and against the plain version (bit-equal at int8,
    within the bf16 bound at bf16); 300,000 rows give 293 tiles (a prime,
    so the blocks' runs of tiles cannot all be equal), with n_valid inside
    the last tile; 1000 rows give a single tile."""
    rng = np.random.default_rng(n + 7)
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    codes = _codes(rng, n, M, K)
    eng = FusedCompressedEngine(cw, codes, precision=precision, device=cuda)
    pipe = FusedCompressedEngine.from_tiles(cw, eng.tiles,
                                            precision=precision, device=cuda,
                                            pipelined=True)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    table, qop, uq, cert, b = eng.prepare(q)
    m1, c1 = eng.scan(qop, uq)
    key = f"stream_mins_pipelined_{precision}"
    before = build.launch_counts()
    m7, c7 = pipe.scan(qop, uq)
    torch.cuda.synchronize()
    after = build.launch_counts()
    assert after[key] == before[key] + 1
    assert after[fk._launch_name("stream_mins", precision)] == \
        before[fk._launch_name("stream_mins", precision)]
    assert torch.equal(c7, c1)
    ref_m, ref_c, pre_max, cross_max = fk.fused_stream_mins_ref(
        qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid, M,
        u=uq, mode=precision, pipelined=True)
    assert torch.equal(c7, ref_c)
    assert torch.equal(m7, m1)
    if precision == "int8":
        assert torch.equal(m7, ref_m)
    else:
        _assert_mins(m7, ref_m, _bf16_tol(pre_max, cross_max))
    d, i = pipe.query(q, top_k=10)
    d1, i1 = eng.query(q, top_k=10)
    assert np.array_equal(d, d1) and np.array_equal(i, i1)


def test_pipelined_refuses_int16_and_m16_on_card(cuda):
    rng = np.random.default_rng(3)
    cw = rng.normal(size=(8, 16, 4)).astype(np.float32)
    codes = _codes(rng, 2000, 8, 16)
    with pytest.raises(NotImplementedError):
        FusedCompressedEngine(cw, codes, precision="int16", device=cuda,
                              pipelined=True)
    cw16 = rng.normal(size=(16, 16, 4)).astype(np.float32)
    with pytest.raises(NotImplementedError):
        FusedCompressedEngine(cw16, _codes(rng, 2000, 16, 16),
                              precision="int8", device=cuda, pipelined=True)


# ---- the tensor-core kernels: B1's narrow tails and B4 ---------------------

def _cut_batch(eng, q):
    """The engine's scan operands for exactly ``len(q)`` queries
    (``prepare`` pads the batch to a multiple of 128)."""
    _, qop, uq, _, b = eng.prepare(q)
    qop = qop[:, :b].contiguous()
    return qop, None if uq is None else uq[..., :b].contiguous()


#: (M, K, Ds): D = 16, 32, 64 and 128
MMA_SHAPES = [(4, 16, 4), (8, 16, 4), (4, 256, 16), (8, 256, 16)]


@pytest.mark.parametrize("precision", ["int16", "int8", "bf16"])
@pytest.mark.parametrize("B", [1, 8, 200, 513])
@pytest.mark.parametrize("n", [2500, 3072])
@pytest.mark.parametrize("M,K,Ds", MMA_SHAPES)
def test_stream_mma_tails_match_plain_and_codes_kernel(cuda, M, K, Ds, n, B,
                                                       precision):
    """B1 on the tensor cores at ragged shapes: batches that fill no
    query block (or one and a bit), n_valid inside a tile and on a tile
    boundary.  Codes exact; int8 bit-equal to the plain version, int16 and
    bf16 inside their bounds; and at int8 and int16 the mins equal, bit
    for bit, those of the codes kernel over the same rows (the same tail
    without the decode)."""
    rng = np.random.default_rng(M * 1000 + Ds * 10 + B + n)
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    codes = _codes(rng, n, M, K)
    eng = FusedCompressedEngine(cw, codes, precision=precision, device=cuda)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    qop, uq = _cut_batch(eng, q)
    assert qop.shape[1] == B
    key = fk._launch_name("stream_mins", precision)
    before = build.launch_counts()[key]
    mins, echo = fk.fused_stream_mins(
        qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid, M,
        u=uq, compact=eng.compact, mode=precision)
    torch.cuda.synchronize()
    assert build.launch_counts()[key] == before + 1
    ref_m, ref_c, pre_max, cross_max = fk.fused_stream_mins_ref(
        qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid, M,
        u=uq, mode=precision)
    assert torch.equal(echo, ref_c)
    assert np.array_equal(echo[:n].cpu().numpy(), codes)
    if precision == "int8":
        assert torch.equal(mins, ref_m)
    else:
        _assert_mins(mins, ref_m, _wide_tol(precision, pre_max, cross_max))
    m3, _ = fk.fused_codes_mins(qop, eng.cwbd, echo, eng.n_valid, u=uq,
                                compact=eng.compact, mode=precision)
    if precision == "bf16":
        _assert_mins(mins, m3, _bf16_tol(pre_max, cross_max))
    else:
        assert torch.equal(mins, m3)


@pytest.mark.parametrize("precision", ["int16", "int8", "bf16"])
def test_stream_mma_tails_many_tiles(cuda, precision):
    """More tiles than the card holds blocks at once (300 tiles of a
    near-distinct code set, 400 queries): a block walks several tiles and
    several query blocks."""
    rng = np.random.default_rng(41)
    n, M, K, Ds, B = 307000, 8, 256, 16, 400
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    codes = _codes(rng, n, M, K)
    eng = FusedCompressedEngine(cw, codes, precision=precision, device=cuda)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    qop, uq = _cut_batch(eng, q)
    mins, echo = eng.scan(qop, uq)
    assert np.array_equal(echo[:n].cpu().numpy(), codes)
    m3, _ = fk.fused_codes_mins(qop, eng.cwbd, echo, eng.n_valid, u=uq,
                                compact=eng.compact, mode=precision)
    if precision == "bf16":
        _, _, pre_max, cross_max = fk.fused_stream_mins_ref(
            qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid,
            M, mode="bf16")
        _assert_mins(mins, m3, _bf16_tol(pre_max, cross_max))
    else:
        assert torch.equal(mins, m3)


#: (tile, tiles, n_valid, B): n_valid inside a tile and on its boundary,
#: one 8192-row tile, 480 rows (no multiple of the kernel's 256-row block
#: tile), batches of 1, 8, 200 and 513
DECODED_CASES = [(1024, 3, 2500, 200), (8192, 1, 8192, 513),
                 (96, 5, 470, 1), (1024, 2, 2048, 8)]


@pytest.mark.parametrize("tile,nt,n_valid,B", DECODED_CASES)
@pytest.mark.parametrize("D", [16, 64, 128, 136, 960, 1024, 2048])
def test_decoded_mma_kernel_matches_plain(cuda, D, tile, nt, n_valid, B):
    """B4 on the tensor cores: D below one slice, D % 16 == 8, D over many
    slices; ragged rows, n_valid and batch."""
    g = torch.Generator(device=cuda).manual_seed(D + tile + B)
    xt = (torch.randn((nt, tile, D), generator=g, device=cuda) * 3).to(
        torch.bfloat16)
    q = (torch.randn((D, B), generator=g, device=cuda) * 3).to(
        torch.bfloat16)
    before = build.launch_counts()["decoded_mins"]
    mins = fk.fused_decoded_mins(q, xt, n_valid)
    torch.cuda.synchronize()
    assert build.launch_counts()["decoded_mins"] == before + 1
    assert mins.shape == (nt * tile // 32, B)
    ref_m, pre_max, cross_max = fk.fused_decoded_mins_ref(q, xt, n_valid)
    _assert_mins(mins, ref_m, _bf16_tol(pre_max, cross_max))


def test_decoded_mma_kernel_many_row_tiles(cuda):
    """More block tiles than the card holds blocks at once, so a block
    walks several with its copy ring running across them."""
    g = torch.Generator(device=cuda).manual_seed(5)
    D, B, n = 72, 300, 150000
    xt = (torch.randn((147, 1024, D), generator=g, device=cuda)).to(
        torch.bfloat16)
    q = torch.randn((D, B), generator=g, device=cuda).to(torch.bfloat16)
    mins = fk.fused_decoded_mins(q, xt, n)
    ref_m, pre_max, cross_max = fk.fused_decoded_mins_ref(q, xt, n)
    _assert_mins(mins, ref_m, _bf16_tol(pre_max, cross_max))


# ---- B3 and B5 on the tensor cores: MmaTail and the gathered wgmma tail ----

#: every tail form of B3 and B5: the narrow shapes (mma.sync), the wide
#: ones (wgmma) and the GIST width at K=256
SCAN_SHAPES = MMA_SHAPES + WIDE_SHAPES + [(16, 256, 60)]


def _scan_engine(kernel, cw, codes, precision, cuda):
    """B1's stream engine for the codes kernel (B3 then runs on its
    echo), the slot-tile engine for B5."""
    return FusedCompressedEngine(
        cw, codes, precision=precision, device=cuda,
        fmt="stream" if kernel == "codes_mins" else "slots")


@pytest.mark.parametrize("precision", ["int16", "int8", "bf16"])
@pytest.mark.parametrize("B", [1, 8, 200, 513])
@pytest.mark.parametrize("n", [2500, 3072])
@pytest.mark.parametrize("M,K,Ds", SCAN_SHAPES)
@pytest.mark.parametrize("kernel", ["codes_mins", "delta_mins"])
def test_codes_and_slot_kernels_on_the_tensor_cores(cuda, kernel, M, K, Ds,
                                                    n, B, precision):
    """B3 and B5 in their tail forms (``scan_tail_form``) at ragged
    shapes: batches that fill no query block (or one and a bit), n_valid
    inside a tile and on its boundary.  Each against its plain version:
    int8 bit-equal, int16 and bf16 inside their bounds; B5's echo equal
    to the codes; B3 on B1's echo equal to B1 bit for bit at int8 and
    int16 (B1 runs the same tail form).  One launch a call."""
    rng = np.random.default_rng(M * 1000 + Ds * 10 + B + n)
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    codes = _chain_codes(rng, n, M, K) if M > 8 else _codes(rng, n, M, K)
    eng = _scan_engine(kernel, cw, codes, precision, cuda)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    qop, uq = _cut_batch(eng, q)
    key = fk._launch_name(kernel, precision)
    if kernel == "codes_mins":
        m1, echo = eng.scan(qop, uq)
        before = build.launch_counts()[key]
        mins, same = fk.fused_codes_mins(qop, eng.cwbd, echo, eng.n_valid,
                                         u=uq, compact=eng.compact,
                                         mode=precision)
        assert same is echo
        ref_m, _, pre_max, cross_max = fk.fused_codes_mins_ref(
            qop, eng.cwbd, echo, eng.n_valid, u=uq, mode=precision)
    else:
        before = build.launch_counts()[key]
        mins, echo = fk.fused_delta_mins(
            qop, eng.cwbd, eng.row_data, eng.ovf, eng.n_valid, eng.tiles.S,
            u=uq, compact=eng.compact, mode=precision)
        ref_m, ref_c, pre_max, cross_max = fk.fused_delta_mins_ref(
            qop, eng.cwbd, eng.row_data, eng.ovf, eng.n_valid, eng.tiles.S,
            u=uq, mode=precision)
        assert torch.equal(echo, ref_c)
    torch.cuda.synchronize()
    assert build.launch_counts()[key] == before + 1
    assert mins.shape == (echo.shape[0] // 32, B)
    assert np.array_equal(echo[:n].cpu().numpy(), codes)
    if precision == "int8":
        assert torch.equal(mins, ref_m)
    else:
        _assert_mins(mins, ref_m, _wide_tol(precision, pre_max, cross_max))
    if kernel == "codes_mins" and precision != "bf16":
        assert torch.equal(mins, m1)


@pytest.mark.parametrize("precision", ["int16", "int8", "bf16"])
@pytest.mark.parametrize("kernel", ["codes_mins", "delta_mins"])
def test_codes_and_slot_kernels_many_tiles_at_gist_width(cuda, kernel,
                                                         precision):
    """The GIST width over more work than the card holds blocks at once
    (147 tiles, 300 queries): a block of the wide tail walks many items
    with its copy ring running across them, and B5's blocks several
    tiles.  B3 equals B1 bit for bit at int8 and int16."""
    rng = np.random.default_rng(43)
    n, M, K, Ds, B = 150000, 16, 256, 60, 300
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    codes = _chain_codes(rng, n, M, K)
    eng = _scan_engine(kernel, cw, codes, precision, cuda)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    qop, uq = _cut_batch(eng, q)
    if kernel == "codes_mins":
        m1, echo = eng.scan(qop, uq)
        mins, _ = fk.fused_codes_mins(qop, eng.cwbd, echo, eng.n_valid,
                                      u=uq, compact=eng.compact,
                                      mode=precision)
        ref_m, _, pre_max, cross_max = fk.fused_codes_mins_ref(
            qop, eng.cwbd, echo, eng.n_valid, u=uq, mode=precision)
        if precision != "bf16":
            assert torch.equal(mins, m1)
    else:
        mins, echo = eng.scan(qop, uq)
        ref_m, _, pre_max, cross_max = fk.fused_delta_mins_ref(
            qop, eng.cwbd, eng.row_data, eng.ovf, eng.n_valid, eng.tiles.S,
            u=uq, mode=precision)
    assert np.array_equal(echo[:n].cpu().numpy(), codes)
    if precision == "int8":
        assert torch.equal(mins, ref_m)
    else:
        _assert_mins(mins, ref_m, _wide_tol(precision, pre_max, cross_max))


# ---- B1 at the wide shapes: the gathered wgmma tail, decoding once ----------

@pytest.mark.parametrize("precision", ["int16", "int8", "bf16"])
@pytest.mark.parametrize("B", [1, 65, 300])
@pytest.mark.parametrize("n", [2500, 3072])
@pytest.mark.parametrize("M,K,Ds", WIDE_SHAPES + [(16, 256, 60)])
def test_stream_kernel_on_the_wgmma_tail(cuda, M, K, Ds, n, B, precision):
    """B1 at the wide shapes (``scan_tail_form`` "wgmma"): batches below,
    at one and a bit and over several query blocks of the tail (64 at
    int16, 256 otherwise), n_valid inside a tile and on its boundary, two
    mask planes at M=16.  Codes exact; int8 bit-equal to the plain
    version, int16 and bf16 inside their bounds; at int8 and int16 equal
    bit for bit to B3 on its echo.  One launch a call."""
    rng = np.random.default_rng(M * 1000 + Ds * 10 + B + n + 7)
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    codes = _chain_codes(rng, n, M, K)
    eng = FusedCompressedEngine(cw, codes, precision=precision, device=cuda)
    assert fk.scan_tail_form("stream_mins", M, Ds) == "wgmma"
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    qop, uq = _cut_batch(eng, q)
    key = fk._launch_name("stream_mins", precision)
    before = build.launch_counts()[key]
    mins, echo = fk.fused_stream_mins(
        qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid, M,
        u=uq, compact=eng.compact, mode=precision)
    torch.cuda.synchronize()
    assert build.launch_counts()[key] == before + 1
    ref_m, ref_c, pre_max, cross_max = fk.fused_stream_mins_ref(
        qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid, M,
        u=uq, mode=precision)
    assert torch.equal(echo, ref_c)
    assert np.array_equal(echo[:n].cpu().numpy(), codes)
    assert mins.shape == (echo.shape[0] // 32, B)
    if precision == "int8":
        assert torch.equal(mins, ref_m)
    else:
        _assert_mins(mins, ref_m, _wide_tol(precision, pre_max, cross_max))
    if precision != "bf16":
        m3, _ = fk.fused_codes_mins(qop, eng.cwbd, echo, eng.n_valid, u=uq,
                                    compact=eng.compact, mode=precision)
        assert torch.equal(mins, m3)


@pytest.mark.parametrize("precision", ["int16", "int8", "bf16"])
def test_stream_kernel_many_tiles_at_gist_width(cuda, precision):
    """The GIST width over more tiles than the card holds blocks at once
    (147 tiles, the last one ragged, 300 queries): a block decodes
    several tiles, each once.  B1 against its plain version, and equal
    bit for bit at int8 and int16 to B3 on its echo and to B5 on the slot
    tiles of the same rows."""
    rng = np.random.default_rng(47)
    n, M, K, Ds, B = 150000, 16, 256, 60, 300
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    codes = _chain_codes(rng, n, M, K)
    eng = FusedCompressedEngine(cw, codes, precision=precision, device=cuda)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    qop, uq = _cut_batch(eng, q)
    mins, echo = eng.scan(qop, uq)
    assert np.array_equal(echo[:n].cpu().numpy(), codes)
    ref_m, _, pre_max, cross_max = fk.fused_stream_mins_ref(
        qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid, M,
        u=uq, mode=precision)
    if precision == "int8":
        assert torch.equal(mins, ref_m)
    else:
        _assert_mins(mins, ref_m, _wide_tol(precision, pre_max, cross_max))
    if precision != "bf16":
        m3, _ = fk.fused_codes_mins(qop, eng.cwbd, echo, eng.n_valid, u=uq,
                                    compact=eng.compact, mode=precision)
        e5 = FusedCompressedEngine(cw, codes, precision=precision,
                                   fmt="slots", device=cuda)
        m5, _ = e5.scan(qop, uq)
        assert torch.equal(mins, m3) and torch.equal(mins, m5)


# ---- B6: the warp selection on its edge cases ---------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x2"])
@pytest.mark.parametrize("case", [c[0] for c in ADC_TOPK_CASES])
def test_adc_topk_kernel_edge_cases(cuda, case, precision):
    """B6 on the cases of tests/_torch_port.py (a tie at the top_k-th place
    between rows 5 and 600 of a tile, a tile with no valid row, top_k
    beyond a tile's valid rows, int32 codes, top_k above 32): bit-equal to
    the plain version and to the NumPy model, one launch."""
    from deltapq_tpu_torch.ops import adc_kernels as ak

    table, codes, n_valid, tile, k = adc_topk_case(case)
    tab, cod = torch.from_numpy(table).to(cuda), torch.from_numpy(codes).to(
        cuda)
    name = ak._mode_name("adc_topk", precision)
    before = build.launch_counts()[name]
    d, i = ak.adc_topk_tiles(tab, cod, n_valid, k, tile, precision)
    torch.cuda.synchronize()
    assert build.launch_counts()[name] == before + 1
    rd, ri = ak.adc_topk_tiles_ref(tab, cod, n_valid, k, tile, precision)
    assert torch.equal(d, rd) and torch.equal(i, ri)
    tables = [t.cpu().numpy() for t in ak._tables_f32(tab, precision)]
    md, mi = adc_topk_tiles_model(table, codes, n_valid, k, tile, tables)
    assert np.array_equal(d.cpu().numpy(), md)
    assert np.array_equal(i.cpu().numpy(), mi)


def test_adc_topk_kernel_many_items(cuda):
    """More (query group, tile) items than the card holds blocks, so a
    block walks a range of them and restages its tables where the query
    group changes; B=300 leaves the last group short.  Every mode
    bit-equal to the plain version."""
    from deltapq_tpu_torch.ops import adc_kernels as ak

    rng = np.random.default_rng(53)
    B, M, K, n, tile, k = 300, 8, 256, 200000, 1024, 10
    table = torch.from_numpy(rng.normal(size=(B, M, K)).astype(np.float32)
                             ).to(cuda)
    codes = torch.from_numpy(pad_codes(_codes(rng, n, M, K), tile)).to(cuda)
    for precision in ("f32", "bf16", "bf16x2"):
        d, i = ak.adc_topk_tiles(table, codes, n, k, tile, precision)
        rd, ri = ak.adc_topk_tiles_ref(table, codes, n, k, tile, precision)
        assert torch.equal(d, rd) and torch.equal(i, ri), precision


def test_cli_on_the_card(cuda, tmp_path):
    """A small CLI run on the card: ``query -engine pallas`` (B6) and
    ``query_compressed -engine auto`` (B1 bf16 + B2 over the DeltaTree)
    held to ``query -engine xla`` on the same card.  Integer vectors and
    codewords make every distance exact, so the three are bit-equal."""
    import contextlib
    import io as _io

    from deltapq_tpu_torch import cli
    from deltapq_tpu_torch.io import write_codewords, write_vecs
    from deltapq_tpu_torch.profiling import Metrics

    rng = np.random.default_rng(11)
    M, K, Ds = 8, 32, 2
    centers = rng.integers(100, 600, size=(24, M * Ds))

    def mk(n):
        x = centers[rng.integers(0, 24, n)] + rng.integers(
            -80, 81, size=(n, M * Ds))
        return np.clip(x, 0, 699).astype(np.float32)

    root = str(tmp_path)
    write_vecs(f"{root}/base.fvecs", mk(5000))
    learn = mk(1000)
    write_vecs(f"{root}/learn.fvecs", learn)
    write_vecs(f"{root}/query.fvecs", mk(100))
    pick = rng.choice(len(learn), K, replace=False)
    write_codewords(f"{root}/M{M}K{K}codewords.txt", np.stack(
        [learn[pick, m * Ds:(m + 1) * Ds] for m in range(M)]))
    common = ["-dataset", root, "-m", str(M), "-k", str(K)]
    out = {}
    with contextlib.redirect_stdout(_io.StringIO()):
        for task in ("encode", "approx_tree"):
            assert cli.main([*common, "-task", task], device=cuda) == 0
        for task, engine in (("query", "xla"), ("query", "pallas"),
                             ("query_compressed", "auto")):
            args = cli.build_parser().parse_args(
                [*common, "-task", task, "-engine", engine, "-topk", "10",
                 "-batch", "64"])
            args.device = cuda
            build.reset_launch_counts()
            out[task, engine] = getattr(cli, f"task_{task}")(args,
                                                             Metrics())
            torch.cuda.synchronize()
            out[task, engine, "launches"] = build.launch_counts()
    xd, xi = out["query", "xla"]
    assert out["query", "pallas", "launches"]["adc_topk"] > 0
    counts = out["query_compressed", "auto", "launches"]
    assert counts["stream_mins_bf16"] > 0 and counts["ladder"] > 0
    for key in (("query", "pallas"), ("query_compressed", "auto")):
        d, i = out[key]
        assert np.array_equal(d, xd), key
        # ids: equal distances make equal rows interchangeable
        for b in range(len(d)):
            assert set(i[b][d[b] < d[b, -1]]) == set(xi[b][xd[b] < xd[b,
                                                                    -1]])


@pytest.mark.parametrize("S", [1, 2])
def test_sharded_delta_step_d_not_divisible_by_m(cuda, S):
    """``make_sharded_delta_query_fn`` over a codebook learned on D=108
    at M=8: ``pq_learn`` pads D to 112, so the last subspace's last 4
    columns are zero in every centered codeword, and the step takes Ds
    from its caller.  Every returned row carries its exact f32 distance,
    the j-th is never below the exact j-th, and certified rows are the
    exact scan's."""
    from deltapq_tpu_torch.ops.delta_tiles import build_delta_tiles
    from deltapq_tpu_torch.ops.encode import pq_encode
    from deltapq_tpu_torch.ops.fused import rung_plan
    from deltapq_tpu_torch.ops.kmeans import pq_learn
    from deltapq_tpu_torch.parallel import make_mesh
    from deltapq_tpu_torch.parallel.fused_sharded import \
        make_sharded_delta_query_fn

    rng = np.random.default_rng(108)
    M, K, D, n, B, k = 8, 64, 108, 4096, 64, 10
    centers = rng.normal(size=(64, D)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 64, n)]
         + rng.normal(size=(n, D)).astype(np.float32) * 0.5)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cw = pq_learn(gen, x, M=M, K=K, max_iters=10, n_init=1, device=cuda)
    Ds = cw.shape[2]
    assert Ds == 14 and not cw[M - 1, :, D - (M - 1) * Ds:].any()
    codes = pq_encode(cw, x).cpu().numpy()
    order = np.lexsort(codes.T[::-1])
    tiles = build_delta_tiles(codes[order])
    cw_np = cw.cpu().numpy()
    q = np.zeros((B, M * Ds), np.float32)
    q[:, :D] = x[rng.integers(0, n, B)] + rng.normal(size=(B, D)) * 0.5
    mu = fk.codebook_center(cw_np)
    qc = q - mu[None, :]
    qk = torch.from_numpy(fk.pack_query_grouped(qc, M, Ds)).to(cuda)
    table = adc_table(cw, torch.from_numpy(q).to(cuda))
    plan = rung_plan(tiles.n_tiles // S * fk.TILE // fk.SUB, k, B)
    fn = make_sharded_delta_query_fn(make_mesh(S, device=cuda), k,
                                     plan.rungs[0], plan.pool, tiles.S,
                                     Ds=Ds)
    d, rows, ok = fn(qk.to(torch.bfloat16).t().contiguous(),
                     torch.from_numpy((qc * qc).sum(axis=1)).to(cuda),
                     table,
                     fk.build_blockdiag_codebook(cw_np, center=mu).to(cuda),
                     torch.from_numpy(tiles.row_data).to(cuda),
                     torch.from_numpy(tiles.ovf).to(cuda), n)
    d, rows, ok = d.cpu().numpy(), rows.cpu().numpy(), ok.cpu().numpy()
    tab = table.cpu().numpy()
    ids = order[rows]
    own = np.zeros_like(d)
    for m in range(M):
        own += tab[np.arange(B)[:, None], m, codes[ids, m]]
    assert np.array_equal(own, d)
    ed, _ = adc_query_topk(table, torch.from_numpy(codes).to(cuda), n, k,
                           1024)
    ed = ed.cpu().numpy()
    assert (d >= ed).all()
    assert ok.mean() >= 0.5
    assert np.array_equal(d[ok], ed[ok])


@pytest.mark.parametrize("shape", ["sift1m", "gist250k"])
def test_edge_search_on_card_equals_host(cuda, shape):
    """The device edge search at the benchmark's shapes: 1M SIFT-shaped
    codes (M=8, one key word) and 250k near-distinct GIST-shaped codes
    (M=16, sampled combinations, two key words), every field equal to
    the NumPy search's, and so the layout and the DTC bytes."""
    from deltapq_tpu_torch.ops.encode import pq_encode
    from deltapq_tpu_torch.ops.kmeans import pq_learn
    from deltapq_tpu_torch.synth import (WORKLOADS, gist_vectors,
                                         workload_vectors)
    from deltapq_tpu_torch.tree.build import find_edges_by_diff
    from deltapq_tpu_torch.tree.build_device import (
        find_edges_by_diff_device)
    from deltapq_tpu_torch.tree.layout import build_layout
    from deltapq_tpu_torch.tree.serialize import serialize_dtc

    if shape == "sift1m":
        M, x = 8, workload_vectors(1_000_000, seed=0,
                                   **WORKLOADS["sift_like"])
    else:
        M, x = 16, gist_vectors(250_000, 960, n_clusters=125_000, seed=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cw = pq_learn(gen, x[:100_000], M=M, K=256, max_iters=10, n_init=1,
                  device=cuda)
    codes = pq_encode(cw, x).cpu().numpy()
    del x
    mem0 = torch.cuda.memory_allocated(cuda)
    b = find_edges_by_diff_device(codes, K=256, device=cuda)
    assert torch.cuda.memory_allocated(cuda) == mem0
    a = find_edges_by_diff(codes, K=256)
    assert np.array_equal(a.edges, b.edges)
    assert a.root_id == b.root_id and a.n_diffs == b.n_diffs
    assert np.array_equal(a.heights, b.heights)
    assert np.array_equal(a.finalists, b.finalists)
    assert a.rounds_log == b.rounds_log
    ta = build_layout(codes, a.edges, a.root_id, K=256, tables="skip")
    tb = build_layout(codes, b.edges, b.root_id, K=256, tables="skip")
    assert np.array_equal(ta.vec_id, tb.vec_id)
    assert np.array_equal(ta.diff_to, tb.diff_to)
    if M <= 8:
        assert serialize_dtc(ta) == serialize_dtc(tb)


@pytest.mark.parametrize("shape", ["sift1m", "gist250k"])
def test_edge_search_on_card_equals_reference(cuda, shape):
    """The card's edge search on hashed codes of the benchmark's shapes
    (1M x 8, one key word; 250k x 16, sampled combinations, two key
    words) gives the reference's result: its fingerprint, computed from
    ``deltapq_tpu.tree.build.find_edges_by_diff`` on the CPU, is checked
    there by test_torch_tree_device.py ``test_reference_at_the_card_shapes``
    (the JAX package does not run here)."""
    from deltapq_tpu_torch.tree.build_device import (
        find_edges_by_diff_device)

    from _torch_port import EDGE_REFERENCE, edge_fingerprint, hashed_codes

    n, M, fp = EDGE_REFERENCE[shape]
    res = find_edges_by_diff_device(hashed_codes(n, M), K=256, device=cuda)
    assert len(res.edges) == n - 1
    assert edge_fingerprint(res) == fp


@pytest.mark.parametrize("method", [1, 2, 3])
def test_index_edge_search_route(cuda, method, monkeypatch):
    """On a card the index builds its edges with the device search for
    methods 1 and 2, and with the NumPy search for method 3."""
    from deltapq_tpu_torch.index import DeltaPQIndex
    from deltapq_tpu_torch.tree import build as pbuild
    from deltapq_tpu_torch.tree import build_device

    routes = []
    for mod, name in ((pbuild, "find_edges_by_diff"),
                      (build_device, "find_edges_by_diff_device")):
        def spy(*a, _real=getattr(mod, name), _name=name, **kw):
            routes.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    rng = np.random.default_rng(method)
    cw = rng.normal(size=(8, 32, 4)).astype(np.float32)
    codes = rng.integers(0, 32, (2000, 8)).astype(np.uint8)
    DeltaPQIndex(cw, codes, engine="fused_compressed", tree_method=method,
                 device=cuda)
    assert routes == (["find_edges_by_diff_device"] if method != 3
                      else ["find_edges_by_diff"])


# ---- the bf16 prepare (csrc/prepare.cu) ------------------------------------

#: (M, K, Ds): SIFT1M's shape, and GIST1M's (two groups, d_pad 1024)
PREPARE_SHAPES = {"sift": (8, 256, 16), "gist": (16, 256, 60)}
#: a subspace wider than the kernel stages at once (two column chunks) and
#: more codewords than it stages at once (two codeword chunks)
PREPARE_WIDE = (2, 300, 200)


def _prepare_case(cuda, shape, n=4000):
    M, K, Ds = PREPARE_SHAPES.get(shape) or PREPARE_WIDE
    rng = np.random.default_rng(M * Ds)
    cw = (rng.normal(size=(M, K, Ds)) * 3 + 1).astype(np.float32)
    return cw, _codes(rng, n, M, K), rng


def _prepare_engine(cuda, shape, kind, precision="bf16"):
    from deltapq_tpu_torch.ops.fused import (FusedCodesEngine,
                                             FusedDecodedEngine)

    cw, codes, rng = _prepare_case(cuda, shape)
    if kind == "decoded":
        return FusedDecodedEngine(cw, codes, tile=1024, device=cuda), rng
    return FusedCodesEngine(cw, codes, precision=precision,
                            device=cuda), rng


@pytest.mark.parametrize("kind", ["codes", "decoded"])
@pytest.mark.parametrize("b", [1, 100, 300, 500, 512])
@pytest.mark.parametrize("shape", sorted(PREPARE_SHAPES))
def test_prepare_kernel_matches_plain(cuda, shape, b, kind):
    """The kernel against its plain version on the card.  qop bit-equal
    (to the host path's operand too).  The table and q2 differ only by the
    order of their f32 sums: q2_bm, c2_mk and the cross term each sum Ds
    (q2: d_pad) products, and a reordered sum moves by a few units in the
    last place of its terms' magnitude; |cross| <= (q2_bm + c2_mk) / 2, so
    every entry stays within 2e-6 (about 17 f32 epsilons) of q2_bm +
    c2_mk."""
    eng, rng = _prepare_engine(cuda, shape, kind)
    _check_prepare_kernel(cuda, eng, rng, b)


@pytest.mark.parametrize("b", [1, 300])
def test_prepare_kernel_wide_subspace(cuda, b):
    """The kernel at Ds 200 and K 300 (the decoded tier, which takes K >
    256): its sums carried over two column chunks and its codewords in two
    chunks, held as in ``test_prepare_kernel_matches_plain``.  A sum's
    reordering error grows with its terms: the table's bound is GIST's
    2e-6 scaled by 200 / 60 terms a sum."""
    eng, rng = _prepare_engine(cuda, "wide", "decoded")
    _check_prepare_kernel(cuda, eng, rng, b, rtol=7e-6)


def _check_prepare_kernel(cuda, eng, rng, b, rtol=2e-6):
    q = (rng.normal(size=(b, eng.D)) * 3 + 1).astype(np.float32)
    qd = torch.from_numpy(q).to(cuda)
    b_pad = -(-b // 128) * 128
    build.reset_launch_counts()
    t, qop, q2 = fk.fused_prepare(qd, eng.codewords, eng.mu_dev, b_pad,
                                  eng._operand_layout())
    torch.cuda.synchronize()
    assert build.launch_counts()["prepare"] == 1
    tr, qopr, q2r = fk.fused_prepare_ref(qd, eng.codewords, eng.mu_dev,
                                         b_pad, eng._operand_layout())
    host = eng._prepare_on_host(q)[1]
    assert torch.equal(qop.view(torch.int16), qopr.view(torch.int16))
    assert torch.equal(qop.view(torch.int16), host.view(torch.int16))
    M, K, Ds = eng.M, eng.K, eng.Ds
    qs = torch.zeros((b_pad, M * Ds), dtype=torch.float64, device=cuda)
    qs[:b] = qd.to(torch.float64)
    q2_bm = (qs.view(b_pad, M, Ds) ** 2).sum(-1)
    c2_mk = (eng.codewords.to(torch.float64) ** 2).sum(-1)
    scale = q2_bm[:, :, None] + c2_mk[None]
    assert bool(((t.double() - tr.double()).abs() <= rtol * scale).all())
    assert bool(((q2 - q2r).abs() <= 2e-6 * q2r.abs()).all())


@pytest.mark.parametrize("shape", sorted(PREPARE_SHAPES))
def test_prepare_engine_answers(cuda, shape):
    """A bf16 engine on the kernel's route: one prepare launch a batch,
    distances bit-equal to ``adc_query_topk`` over the engine's own table,
    ids equal to the host route's up to ties."""
    from _torch_port import assert_ids_up_to_ties

    cw, codes, rng = _prepare_case(cuda, shape, n=20000)
    M, K, Ds = PREPARE_SHAPES[shape]
    eng = FusedCompressedEngine(cw, codes, precision="bf16", device=cuda)
    q = (rng.normal(size=(300, M * Ds)) * 3 + 1).astype(np.float32)
    top_k = 10 if shape == "sift" else 100
    build.reset_launch_counts()
    d, i = eng.query(q, top_k=top_k)
    assert build.launch_counts()["prepare"] == 1
    table = eng.prepare(q)[0][:len(q)]
    scan = decode_stream_tiles(eng.tiles)
    dr, _ = adc_query_topk(table, torch.from_numpy(pad_codes(scan, 1024))
                           .to(cuda), len(scan), top_k, 1024)
    assert np.array_equal(d, dr.cpu().numpy())
    th, qh, uh, ch, bh = eng._prepare_on_host(q)
    mins, echo = eng.scan(qh, uh)
    dh, ih = eng.select(th, ch, mins, echo, bh, top_k)
    np.testing.assert_allclose(d, dh.numpy(), rtol=1e-5, atol=1e-4)
    assert_ids_up_to_ties(th[:len(q)].cpu().numpy(), scan, i, ih.numpy(),
                          top_k)


def test_prepare_sharded_engine(cuda):
    """The sharded engine on one card: its first shard's prepare takes the
    kernel once a batch, every shard scans that table and operand.  Each
    shard's ``calibrate`` queries the shard alone, so each prepares on its
    own route too."""
    from deltapq_tpu_torch.parallel import make_mesh
    from deltapq_tpu_torch.parallel.fused_sharded import (
        ShardedCompressedEngine)

    cw, codes, rng = _prepare_case(cuda, "sift", n=20000)
    e = ShardedCompressedEngine(cw, codes, make_mesh(2, device=cuda))
    build.reset_launch_counts()
    e.calibrate(top_k=10)
    assert build.launch_counts()["prepare"] >= 2
    q = (rng.normal(size=(200, 128)) * 3 + 1).astype(np.float32)
    build.reset_launch_counts()
    d, _ = e.query(q, top_k=10)
    assert build.launch_counts()["prepare"] == 1
    table = e.shards[0][0].prepare(q)[0][:len(q)]
    dr, _ = adc_query_topk(table, torch.from_numpy(pad_codes(codes, 1024))
                           .to(cuda), len(codes), 10, 1024)
    assert np.array_equal(d, dr.cpu().numpy())


@pytest.mark.parametrize("precision", ["bf16", "int8", "int16"])
def test_prepare_launches_per_batch(cuda, precision):
    """``launch_counts()['prepare']``: one a batch at bf16, none on the
    int8 and int16 host route."""
    eng, rng = _prepare_engine(cuda, "sift", "codes", precision)
    build.reset_launch_counts()
    for b in (1, 300, 512):
        eng.query((rng.normal(size=(b, eng.D)) * 3).astype(np.float32))
    assert build.launch_counts()["prepare"] == (3 if precision == "bf16"
                                                else 0)
