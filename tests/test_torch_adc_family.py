"""The plain-scan kernel family of ``ops/adc_kernels.py`` (the distance
matrix, the argmin top-k at bf16 / bf16x2, the packed top-k, the
tile-dictionary scan and its engine) against the JAX Pallas kernels in
interpret mode.  On the CPU the port runs its plain versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deltapq_tpu_torch.convert import tile_dict_state_from_numpy
from deltapq_tpu_torch.kernels import build
from deltapq_tpu_torch.ops import adc as padc
from deltapq_tpu_torch.ops import adc_kernels as ak
from deltapq_tpu_torch.tree.build import find_edges_by_diff
from deltapq_tpu_torch.tree.layout import build_layout

from _torch_port import CPU, assert_ids_up_to_ties, codebook, structured_codes


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernels in interpret mode (as
    tests/test_adc_pallas.py does) and keep what each ``pallas_call``
    returned, so a kernel's own output can be compared."""
    from jax.experimental import pallas as pl
    import deltapq_tpu.ops.adc_pallas as ap

    orig = pl.pallas_call
    ap.kernel_outputs = []

    def patched(*a, **k):
        fn = orig(*a, **{**k, "interpret": True})

        def run(*args):
            out = fn(*args)
            ap.kernel_outputs.append(out)
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield ap
    del ap.kernel_outputs


def _problem(seed, B, M, K, n, tile, dup=False, positive=False):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(B, M, K)).astype(np.float32) * 10
    if positive:
        table = np.abs(table)
    if dup:
        codes = structured_codes(rng, n, M, min(K, 256))
    else:
        codes = rng.integers(0, K, size=(n, M))
    codes = codes.astype(np.uint8 if K <= 256 else np.int32)
    return table, padc.pad_codes(codes, tile)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rounded_table(table, precision):
    """The f64 table a precision really sums (for the tie audit)."""
    return sum(t.to(torch.float64)
               for t in ak._tables_f32(_t(table), precision)).numpy()


def test_split_bf16_and_row_bits_match_jax(interpret):
    x = np.random.default_rng(0).normal(size=(64, 33)).astype(
        np.float32) * 100
    jh, jl = interpret.split_bf16(jnp.asarray(x))
    h, l = ak.split_bf16(_t(x))
    assert np.array_equal(np.asarray(jh.astype(jnp.float32)),
                          h.to(torch.float32).numpy())
    assert np.array_equal(np.asarray(jl.astype(jnp.float32)),
                          l.to(torch.float32).numpy())
    assert ak._ROW_BITS == interpret._ROW_BITS


@pytest.mark.parametrize("B,M,K,n,tile", [
    (8, 4, 16, 256, 64),
    (16, 8, 256, 2048, 512),
    (5, 8, 512, 768, 256)])                 # K > 256: int32 codes
def test_adc_dists_matches_jax_kernel(interpret, B, M, K, n, tile):
    table, codes = _problem(n, B, M, K, n, tile)
    jd = interpret.adc_dists_pallas.__wrapped__(
        jnp.asarray(table), jnp.asarray(codes), tile_n=tile)
    before = build.launch_counts()
    d = ak.adc_dists_pallas(_t(table), _t(codes), tile)
    assert build.launch_counts() == before       # CPU tensors: the plain one
    assert d.shape == (B, n)
    # one-hot products select exact table values; both sum in ascending m
    assert np.array_equal(d.numpy(), np.asarray(jd))
    assert torch.equal(d, padc.adc_tile_dists(_t(table), _t(codes)))


@pytest.mark.parametrize("precision", ["bf16", "bf16x2"])
@pytest.mark.parametrize("B,M,K,n,tile,k,dup", [
    (8, 4, 16, 250, 64, 5, False),          # padding rows in the last tile
    (16, 8, 256, 3000, 512, 10, True),      # duplicate rows: ties
    (8, 8, 512, 1500, 256, 10, False),      # K > 256: int32 codes
    (4, 4, 16, 100, 64, 40, False)])        # top_k beyond a tile's rows
def test_adc_topk_bf16_modes_match_jax_kernel(interpret, precision, B, M, K,
                                              n, tile, k, dup):
    table, codes = _problem(n + k, B, M, K, n, tile, dup)
    jd, ji = interpret.adc_topk_pallas.__wrapped__(
        jnp.asarray(table), jnp.asarray(codes), jnp.int32(n), top_k=k,
        tile_n=tile, precision=precision)
    d, i = ak.adc_topk_pallas(_t(table), _t(codes), n, k, tile, precision)
    # products of a one-hot with bf16 values are exact; same f32 order
    assert np.array_equal(d.numpy(), np.asarray(jd))
    # the per-tile kernel outputs too
    jdt, jit = interpret.kernel_outputs[-1]
    dt, it = ak.adc_topk_tiles(_t(table), _t(codes), n, k, tile, precision)
    assert np.array_equal(dt.numpy(), np.asarray(jdt))
    fin = np.isfinite(d.numpy())
    assert (i.numpy()[fin] < n).all()
    assert_ids_up_to_ties(_rounded_table(table, precision), codes[:n],
                          np.where(fin, i.numpy(), -1),
                          np.where(fin, np.asarray(ji), -1), min(k, n))


def test_adc_topk_default_precision_is_jax_default(interpret):
    table, codes = _problem(3, 4, 4, 16, 200, 64)
    jd, _ = interpret.adc_topk_pallas.__wrapped__(
        jnp.asarray(table), jnp.asarray(codes), jnp.int32(200), top_k=5,
        tile_n=64)
    d, _ = ak.adc_topk_pallas(_t(table), _t(codes), 200, 5, 64)
    d2, _ = ak.adc_topk_pallas(_t(table), _t(codes), 200, 5, 64, "bf16x2")
    assert np.array_equal(d.numpy(), np.asarray(jd))
    assert torch.equal(d, d2)


PACKED_CASES = [
    # B, M, K, n, tile, k, dup, positive
    (8, 4, 16, 250, 64, 5, False, False),     # n_valid inside the last tile,
                                              # negative table values
    (16, 8, 256, 3000, 512, 10, True, True),  # duplicate rows
    (8, 8, 512, 1500, 256, 10, False, True),  # K > 256: int32 codes
    (4, 4, 16, 100, 64, 40, False, False),    # top_k beyond a tile's rows
    (3, 8, 64, 4096, 4096, 7, True, False)]   # the widest tile


@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x2"])
@pytest.mark.parametrize("B,M,K,n,tile,k,dup,positive", PACKED_CASES)
def test_adc_topk_packed_matches_jax_kernel(interpret, precision, B, M, K, n,
                                            tile, k, dup, positive):
    table, codes = _problem(n * 3 + k, B, M, K, n, tile, dup, positive)
    jd, ji = interpret.adc_topk_packed.__wrapped__(
        jnp.asarray(table), jnp.asarray(codes), jnp.int32(n), top_k=k,
        tile_n=tile, precision=precision)
    jkeys = np.asarray(interpret.kernel_outputs[-1])
    before = build.launch_counts()
    keys = ak.adc_topk_packed_tiles(_t(table), _t(codes), n, k, tile,
                                    precision)
    assert build.launch_counts() == before
    assert keys.dtype == torch.int32
    assert np.array_equal(keys.numpy(), jkeys)        # bit-equal keys
    d, i = ak.adc_topk_packed(_t(table), _t(codes), n, k, tile, precision)
    assert np.array_equal(i.numpy(), np.asarray(ji))  # unique by key
    assert np.array_equal(d.numpy(), np.asarray(jd))
    own = ak._exact_dists_for_ids(_t(table), _t(codes), i)
    assert torch.equal(d, own)                        # exact f32 readout
    live = i.numpy() < n
    if precision == "f32":
        # selection is exact up to the key's 12 truncated bits
        dr, _ = padc.adc_query_topk(_t(table), padc.pad_codes(_t(codes),
                                                              4096), n, k,
                                    4096)
        kk = min(k, n)
        got = np.sort(np.where(live, d.numpy(), np.inf), axis=1)[:, :kk]
        np.testing.assert_allclose(got, dr.numpy()[:, :kk], rtol=2e-3,
                                   atol=1e-30)


def test_packed_keys_order_any_sign():
    """The key orders as the float does across zero, and keeps the row."""
    vals = torch.tensor([-3.5, -1e-3, -0.0, 0.0, 1e-3, 2.0, 1e9],
                        dtype=torch.float32)
    keys = ak.packed_keys(vals, torch.zeros(7, dtype=torch.int32),
                          torch.ones(7, dtype=torch.bool))
    assert (keys[1:] >= keys[:-1]).all() and keys[0] < keys[-1]
    k2 = ak.packed_keys(vals, torch.full((7,), 4095, dtype=torch.int32),
                        torch.tensor([True] * 6 + [False]))
    assert ((k2[:6] & 0xFFF) == 4095).all() and int(k2[6]) == 0x7FFFFFFF


def _clustered(seed, n, M, K, pool=24, mut=0.03):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, K, size=(pool, M))
    codes = base[rng.integers(0, pool, n)]
    flip = rng.random(codes.shape) < mut
    return np.where(flip, rng.integers(0, K, codes.shape), codes).astype(
        np.uint8)


@pytest.mark.parametrize("n,M,K,tile,max_dict", [
    (1024, 4, 64, 256, 64),
    (2048, 8, 256, 512, 64),
    (512, 4, 256, 256, 8)])                   # does not fit: None
def test_build_tile_dict_is_a_copy(interpret, n, M, K, tile, max_dict):
    codes = _clustered(n, n, M, K)
    codes = codes[np.lexsort(codes.T[::-1])]
    want = interpret.build_tile_dict(codes, tile_n=tile, max_dict=max_dict)
    got = ak.build_tile_dict(codes, tile_n=tile, max_dict=max_dict)
    if want is None:
        assert got is None
        return
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got[2] == want[2]


@pytest.mark.parametrize("B,M,K,n,tile,k", [
    (8, 4, 64, 1000, 256, 5),                 # n_valid inside the last tile
    (16, 8, 256, 4096, 2048, 10),
    (4, 4, 64, 300, 256, 60)])                # top_k beyond the last tile
def test_adc_topk_tiledict_matches_jax_and_packed_f32(interpret, B, M, K, n,
                                                      tile, k):
    rng = np.random.default_rng(n)
    table = rng.normal(size=(B, M, K)).astype(np.float32) * 10
    codes = _clustered(n + 1, n, M, K, mut=0.01)
    codes = padc.pad_codes(codes[np.lexsort(codes.T[::-1])], tile)
    dicts, idx, D = ak.build_tile_dict(codes, tile_n=tile)
    jd, ji = interpret.adc_topk_tiledict.__wrapped__(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(dicts),
        jnp.asarray(codes), jnp.int32(n), top_k=k, tile_n=tile)
    jkeys = np.asarray(interpret.kernel_outputs[-1])
    keys = ak.adc_topk_tiledict_tiles(_t(table), _t(idx), _t(dicts), n, k,
                                      tile)
    assert np.array_equal(keys.numpy(), jkeys)
    # both stages select exact f32 values: the packed kernel's f32 keys
    assert torch.equal(keys, ak.adc_topk_packed_tiles(
        _t(table), _t(codes), n, k, tile, "f32"))
    d, i = ak.adc_topk_tiledict(_t(table), _t(idx), _t(dicts), _t(codes), n,
                                k, tile)
    assert np.array_equal(i.numpy(), np.asarray(ji))
    assert np.array_equal(d.numpy(), np.asarray(jd))


@pytest.mark.parametrize("M,K,Ds,tile", [(8, 256, 4, 512), (4, 64, 8, 256)])
def test_tile_dict_engine_in_dfs_order(interpret, M, K, Ds, tile):
    rng = np.random.default_rng(M + K)
    cw = codebook(rng, M, K, Ds)
    codes = _clustered(K, 3000, M, K)
    res = find_edges_by_diff(codes, K=K, method=1)
    tree = build_layout(codes, res.edges, res.root_id, K=K, tables="skip")
    order = tree.vec_id.astype(np.int64)
    q = rng.normal(size=(12, M * Ds)).astype(np.float32) * 3
    jeng = interpret.TileDictEngine(cw, codes, order=order, tile_n=tile)
    eng = ak.TileDictEngine(cw, codes, order=order, tile_n=tile, device=CPU)
    assert eng.ok and jeng.ok and eng.dict_width == jeng.dict_width
    assert np.array_equal(eng.dicts.numpy(), np.asarray(jeng.dicts))
    assert np.array_equal(eng.idx.numpy(), np.asarray(jeng.idx))
    jd, ji = jeng.query(q, top_k=10)
    d, i = eng.query(q, top_k=10)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)  # the tables'
    # the same engine state in both packages
    twin = tile_dict_state_from_numpy(
        cw, np.asarray(jeng.dicts), np.asarray(jeng.idx),
        np.asarray(jeng.codes_reordered), np.asarray(jeng.row_to_db),
        jeng.n_valid, tile_n=tile, device=CPU)
    d2, i2 = twin.query(q, top_k=10)
    assert np.array_equal(d, d2) and np.array_equal(i, i2)
    table = padc.adc_table(_t(cw), _t(q)).numpy()
    assert_ids_up_to_ties(table, codes, i, ji, 10)
    # against the plain exact scan: the same exact distances for the
    # returned ids, the same sets up to the key's 12 truncated bits
    dp, ip = padc.query_plain(cw, q, codes, top_k=10, engine="xla",
                              device=CPU)
    np.testing.assert_allclose(np.sort(d, axis=1), dp, rtol=2e-3)
    exact = ak._exact_dists_for_ids(_t(table), _t(codes), _t(i))
    assert np.array_equal(exact.numpy(), d)


def test_tile_dict_engine_that_does_not_fit_raises():
    rng = np.random.default_rng(5)
    cw = codebook(rng, 4, 256, 4)
    codes = rng.integers(0, 256, size=(1000, 4)).astype(np.uint8)
    eng = ak.TileDictEngine(cw, codes, tile_n=512, max_dict=16, device=CPU)
    assert not eng.ok
    with pytest.raises(RuntimeError):
        eng.query(np.zeros((2, 16), np.float32))


def test_exact_dists_for_ids_matches_jax(interpret):
    table, codes = _problem(9, 6, 8, 256, 500, 500)
    ids = np.random.default_rng(1).integers(-1, 600, size=(6, 10)).astype(
        np.int32)
    want = interpret._exact_dists_for_ids(
        jnp.asarray(table), jnp.asarray(codes.astype(np.int32)),
        jnp.asarray(ids))
    got = ak._exact_dists_for_ids(_t(table), _t(codes), _t(ids))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("call", [
    # tile_n > 4096 for the packed kernels
    lambda t, c: ak.adc_topk_packed(t, c, 8192, 5, 8192, "f32"),
    lambda t, c: ak.adc_topk_tiledict(
        t, c, torch.zeros((1, 4, 8), dtype=torch.int32), c, 8192, 5, 8192),
    # a dictionary wider than 256
    lambda t, c: ak.adc_topk_tiledict(
        t, c, torch.zeros((4, 4, 512), dtype=torch.int32), c, 8192, 5, 2048),
    # unknown precision
    lambda t, c: ak.adc_topk_packed(t, c, 8192, 5, 2048, "fp8"),
    lambda t, c: ak.adc_topk_pallas(t, c, 8192, 5, 2048, "fp8"),
    # N % tile_n != 0
    lambda t, c: ak.adc_dists_pallas(t, c, 3000),
    lambda t, c: ak.adc_topk_packed(t, c, 8192, 5, 3000, "f32"),
    # int64 codes
    lambda t, c: ak.adc_dists_pallas(t, c.to(torch.int64), 512),
    # u8 codes cannot address K > 256
    lambda t, c: ak.adc_dists_pallas(torch.zeros((2, 4, 512)), c, 512),
])
def test_wrong_operands_raise(call):
    table = torch.zeros((2, 4, 16))
    codes = torch.zeros((8192, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        call(table, codes)
