"""The port's ADC top-k (B6, f32) plain version against the JAX Pallas
kernel in interpret mode, and ``query_plain`` for each engine.  The
``bf16`` and ``bf16x2`` precisions: tests/test_torch_adc_family.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deltapq_tpu.ops import adc as jadc
from deltapq_tpu_torch.kernels import build
from deltapq_tpu_torch.ops import adc as padc
from deltapq_tpu_torch.ops import adc_kernels as ak

from _torch_port import (ADC_TOPK_CASES, CPU, adc_topk_case,
                         adc_topk_tiles_model, assert_ids_up_to_ties,
                         codebook, structured_codes)


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernels in interpret mode (as
    tests/test_adc_pallas.py does): adc_pallas passes no interpret flag."""
    from jax.experimental import pallas as pl
    import deltapq_tpu.ops.adc_pallas as ap

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    return ap


def _problem(seed, B, M, K, n, tile, dup=False):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(B, M, K)).astype(np.float32) * 10
    if dup:
        codes = structured_codes(rng, n, M, min(K, 256))
    else:
        codes = rng.integers(0, K, size=(n, M))
    codes = codes.astype(np.uint8 if K <= 256 else np.int32)
    return table, padc.pad_codes(codes, tile)


@pytest.mark.parametrize("B,M,K,n,tile,k,dup", [
    (8, 4, 16, 250, 64, 5, False),          # padding rows in the last tile
    (16, 8, 256, 3000, 512, 10, True),      # duplicate rows: ties
    (8, 8, 512, 1500, 256, 10, False),      # K > 256: int32 codes
    (4, 4, 16, 100, 64, 40, False)])        # top_k beyond a tile's rows
def test_adc_topk_plain_matches_jax_kernel(interpret, B, M, K, n, tile, k,
                                           dup):
    table, codes = _problem(n + k, B, M, K, n, tile, dup)
    jd, ji = interpret.adc_topk_pallas.__wrapped__(
        jnp.asarray(table), jnp.asarray(codes), jnp.int32(n), top_k=k,
        tile_n=tile, precision="f32")
    d, i = ak.adc_topk_pallas(torch.from_numpy(table),
                              torch.from_numpy(codes), n, k, tile, "f32")
    # one-hot products select exact table values; both sum in ascending m
    assert np.array_equal(d.numpy(), np.asarray(jd))
    fin = np.isfinite(d.numpy())
    assert (i.numpy()[fin] < n).all()
    assert_ids_up_to_ties(table, codes[:n], np.where(fin, i.numpy(), -1),
                          np.where(fin, np.asarray(ji), -1), min(k, n))
    # bit-equal to the plain exact scan
    dr, _ = padc.adc_query_topk(torch.from_numpy(table),
                                padc.pad_codes(torch.from_numpy(codes),
                                               1024), n, k, 1024)
    assert torch.equal(d, dr)


def test_tile_topk_semantics():
    """Tile-local rows, lower row first among equal values, and a tile
    with fewer than top_k finite rows repeating its lowest row at +inf
    (what argmin over an all-inf column gives)."""
    table = np.zeros((1, 1, 4), np.float32)
    table[0, 0] = [3.0, 1.0, 1.0, 2.0]
    codes = np.array([[0], [1], [2], [1], [3], [0], [0], [0]], np.uint8)
    d, i = ak.adc_topk_tiles(torch.from_numpy(table),
                             torch.from_numpy(codes), 6, 5, 4)
    assert d[:, :, 0].tolist() == [[1.0, 1.0, 1.0, 3.0, float("inf")],
                                   [2.0, 3.0, float("inf"), float("inf"),
                                    float("inf")]]
    assert i[:, :, 0].tolist() == [[1, 2, 3, 0, 0], [0, 1, 0, 0, 0]]
    before = build.launch_counts()
    ak.adc_topk_tiles(torch.from_numpy(table), torch.from_numpy(codes), 6,
                      5, 4)
    assert build.launch_counts() == before       # CPU tensors: the plain one


@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x2"])
@pytest.mark.parametrize("case", [c[0] for c in ADC_TOPK_CASES])
def test_tile_topk_plain_edge_cases(case, precision):
    """The plain version on the cases the card's warp selection must get
    right (tests/_torch_port.py): a tie at the top_k-th place between
    rows 5 and 600 of a tile, a tile with no valid row, top_k beyond a
    tile's valid rows, int32 codes -- against the NumPy model of what
    top_k rounds of mask-argmin give."""
    table, codes, n_valid, tile, k = adc_topk_case(case)
    tables = [t.numpy() for t in ak._tables_f32(torch.from_numpy(table),
                                                 precision)]
    md, mi = adc_topk_tiles_model(table, codes, n_valid, k, tile, tables)
    d, i = ak.adc_topk_tiles(torch.from_numpy(table),
                             torch.from_numpy(codes), n_valid, k, tile,
                             precision)
    assert np.array_equal(d.numpy(), md) and np.array_equal(i.numpy(), mi)
    if case == "ties":
        # the nine -400 rows, then row 5 ahead of row 600 at -360
        assert (i.numpy()[0, :, 0].tolist()
                == [1, 70, 200, 333, 512, 700, 801, 950, 1023, 5])
    else:
        assert np.isinf(md[-1]).all() and (mi[-1] == 0).all()  # empty
        assert np.isinf(md[-2, -1]).all()     # fewer valid rows than top_k


@pytest.mark.parametrize("engine", ["xla", "pallas", "auto"])
@pytest.mark.parametrize("M,K,Ds", [(8, 256, 4), (4, 32, 8)])
def test_query_plain_matches_jax(engine, M, K, Ds):
    rng = np.random.default_rng(M * K)
    cw = codebook(rng, M, K, Ds)
    codes = structured_codes(rng, 5000, M, K)
    q = rng.normal(size=(40, M * Ds)).astype(np.float32) * 3
    jd, ji = jadc.query_plain(cw, q, codes, top_k=10, engine="xla")
    d, i = padc.query_plain(cw, q, codes, top_k=10, engine=engine, device=CPU)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)
    table = padc.adc_table(torch.from_numpy(cw), torch.from_numpy(q))
    assert_ids_up_to_ties(table.numpy(), codes, i, np.asarray(ji), 10)
    dx, _ = padc.query_plain(cw, q, torch.from_numpy(codes), top_k=10,
                             engine="xla", device=CPU)
    assert np.array_equal(d, dx)             # every engine: the same bits


def test_bad_operands_raise():
    table = torch.zeros((2, 4, 16))
    with pytest.raises(ValueError):                # N_pad % tile_n != 0
        ak.adc_topk_pallas(table, torch.zeros((100, 4), dtype=torch.uint8),
                           64, 5, 64)
    with pytest.raises(ValueError):                # codes wider than M
        ak.adc_topk_pallas(table, torch.zeros((64, 5), dtype=torch.uint8),
                           64, 5, 64)
    with pytest.raises(ValueError):
        padc.query_plain(np.zeros((4, 16, 2), np.float32),
                         np.zeros((2, 8), np.float32),
                         np.zeros((10, 4), np.uint8), engine="nope",
                         device=CPU)


def test_bench_adc_rehearses_on_the_cpu(capsys):
    """The ADC benchmark's flow with the plain versions: B6 and B9 in every
    mode and B10 in both row orders held to their plain versions, then B10
    beside B9 f32 on the dup_heavy codes; no time printed as a device
    time."""
    from deltapq_tpu_torch import bench_adc
    assert bench_adc.main(["6000", "8"], device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("bit-equal to its plain version") == 6
    assert out.count("so is B9; B9 / B6 = nan") == 6
    assert out.count("B10 nan ms") == 3
    assert "dup_heavy lexsort: B10 nan ms" in out
    assert "cpu (plain versions; no device time)" in out
    assert "nan ms" in out


@pytest.mark.parametrize("variant", ["whole", "group8", "group16",
                                     "warps16", "no-select"])
def test_adc_ablation_variants_match_the_kernel_source(variant):
    """Each ablation of ``adc_topk.cu`` replaces a line that is in the
    source exactly once, so no variant silently equals the whole kernel."""
    from deltapq_tpu_torch.kernels import ablate_adc
    src = (build.CSRC_DIR / "adc_topk.cu").read_text()
    assert set(ablate_adc.VARIANTS) == {"whole", "group8", "group16",
                                        "warps16", "no-select"}
    out = build.variant_source(src, ablate_adc.VARIANTS[variant], variant)
    assert (out == src) == (variant == "whole")
    assert "adc_topk_launch" in out


@pytest.mark.parametrize("script,source,variant", [
    ("ablate_tiledict", "adc_topk.cu", v) for v in (
        "whole", "group4", "group8", "group16", "query-major",
        "no-select")] + [
    ("ablate_dists", "adc_dists.cu", v) for v in (
        "none", "a", "b", "c", "ab", "ac", "bc", "abc", "qv1", "run8",
        "w24", "w16", "no-store", "no-lookup")])
def test_ablation_variants_match_their_sources(script, source, variant):
    """B10's and B8's ablations: each variant's replacements are in the
    source exactly once, and only the package's own variant (B10 ``whole``,
    B8 ``ab``) builds the source unchanged."""
    import importlib

    mod = importlib.import_module(f"deltapq_tpu_torch.kernels.{script}")
    variants = {**mod.VARIANTS, **getattr(mod, "DIAGNOSTICS", {})}
    assert variant in variants
    src = (build.CSRC_DIR / source).read_text()
    out = build.variant_source(src, variants[variant], variant)
    assert (out == src) == (variant in ("whole", "ab"))


def test_ablation_variant_without_its_line_raises():
    with pytest.raises(RuntimeError, match="no longer has"):
        build.variant_source("int x = 1;", [("int y = 2;", "int y = 3;")],
                             "broken")
