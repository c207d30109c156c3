"""The GIST shape (M=16, Ds=60, D=960, top-100: two subspace groups, two
mask planes) and the pipelined stream kernel of the port against the JAX
package, on the same NumPy inputs.  The JAX side runs as its own tests
run it on the CPU (Pallas in interpret mode); the port runs its plain
versions on ``device="cpu"``.

Tolerances: codes exact; int8 mins bit-equal (every partial sum is an
integer below 2^24 = 127^2 * 1040, exact in f32 in any order; 960 dims
here); int16 within 4e-6 (max pre + 2 max|u cross|) -- the digit products
are exact on both sides, the f32 pre sum and the digit combination round,
and with two groups the JAX kernel rounds once more, adding the groups in
f32; bf16 within 2e-5 (max pre + 2 sqrt(max pre) max ||q||): two f32 sums
of the same exact bf16 products in two orders (measured at 960 dims, the
error stays under a tenth of that).  Engines: distances rtol 1e-5, atol
1e-4 (table ulps between the frameworks), ids up to f64-audited ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deltapq_tpu.index import DeltaPQIndex as JIndex
from deltapq_tpu.ops import fused as jfused
from deltapq_tpu.ops import fused_pallas as jfp
from deltapq_tpu_torch import synth
from deltapq_tpu_torch.convert import load_jax_engine, load_jax_index
from deltapq_tpu_torch.index import DeltaPQIndex
from deltapq_tpu_torch.kernels import build
from deltapq_tpu_torch.ops import fused as pfused
from deltapq_tpu_torch.ops import fused_kernels as fk
from deltapq_tpu_torch.ops.adc import adc_table

from _torch_port import CPU, assert_ids_carry_dists, assert_ids_up_to_ties

PRECISIONS = ("int16", "int8", "bf16")


def int16_tol(pre_max, cross_max):
    return 4e-6 * (pre_max + 2 * cross_max)


def bf16_tol(pre_max, cross_max):
    return 2e-5 * (pre_max + 2 * cross_max)


def assert_mins(got, want, precision, pre_max, cross_max):
    got, want = np.asarray(got), np.asarray(want)
    if precision == "int8":
        assert np.array_equal(got, want)
        return
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    tol = (int16_tol if precision == "int16" else bf16_tol)(pre_max,
                                                            cross_max)
    assert np.abs(got[fin] - want[fin]).max() <= tol


@pytest.fixture(scope="module")
def gist_setup():
    """The recipe of tests/test_fused.py ``gist_setup``: M=16, K=32,
    Ds=60, chain-correlated codes so the tiles compress."""
    rng = np.random.default_rng(8)
    M, K, Ds, n, B = 16, 32, 60, 4000, 16
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    codes = np.empty((n, M), np.uint8)
    codes[0] = rng.integers(0, K, size=M)
    for i in range(1, n):
        codes[i] = codes[i - 1]
        for _ in range(rng.integers(1, 3)):
            codes[i, rng.integers(0, M)] = rng.integers(0, K)
    queries = rng.normal(size=(B, M * Ds)).astype(np.float32)
    return cw, codes, queries


def _operands(jeng, queries, precision):
    """Both packages' query operands from the same queries; the port's
    must be the JAX package's bit for bit."""
    M, Ds = jeng.M, jeng.Ds
    q, _ = jfused._pad_queries(queries, jeng.d_pad)
    qk = jfp.pack_query_grouped((q - jeng.mu[None])[:, :jeng.D], M, Ds)
    assert np.array_equal(fk.pack_query_grouped(
        (q - jeng.mu[None])[:, :jeng.D], M, Ds), qk)
    jq, _, ju, _ = jfused._mins_query_args(qk, precision, jeng.scale)
    qop, uq, _ = pfused._mins_query_args(qk, precision, jeng.scale, "cpu")
    G, _, Dg_pad = fk.group_geometry(M, Ds)
    assert qop.shape[0] == (2 if precision == "int16" else 1) * G * Dg_pad
    if precision == "bf16":
        assert np.array_equal(qop.view(torch.int16).numpy(),
                              np.asarray(jq).view(np.int16))
    else:
        assert np.array_equal(qop.numpy(), np.asarray(jq))
        assert np.array_equal(uq.numpy(), np.asarray(ju))
    return jq, ju, qop, uq


def _same_codebook(peng, jeng, precision):
    if precision == "bf16":
        assert np.array_equal(peng.cwbd.view(torch.int16).numpy(),
                              np.asarray(jeng.cwbd).view(np.int16))
    else:
        assert peng.scale == jeng.scale and peng.err_c == jeng.err_c
        assert np.array_equal(peng.cwbd.numpy(), np.asarray(jeng.cwbd))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_gist_stream_mins_matches_jax_kernel(gist_setup, precision):
    cw, codes, queries = gist_setup
    jeng = jfused.FusedCompressedEngine(cw, codes, precision=precision)
    assert jeng.tiles.n_planes == 2
    peng = pfused.FusedCompressedEngine(cw, codes, precision=precision,
                                        device=CPU)
    for name in ("row_data", "vals", "meta"):
        assert np.array_equal(getattr(peng.tiles, name),
                              getattr(jeng.tiles, name)), name
    _same_codebook(peng, jeng, precision)
    jq, ju, qop, uq = _operands(jeng, queries, precision)
    jm, jecho = jfp.fused_stream_mins(
        jq, jeng.cwbd, jeng.row_data, jeng.vals, jeng.meta,
        jnp.int32(jeng.n_valid), jeng.tiles.e_max, jeng.M, u=ju,
        int16=precision == "int16")
    mins, echo, pre_max, cross_max = fk.fused_stream_mins_ref(
        qop, peng.cwbd, peng.row_data, peng.vals, peng.meta, peng.n_valid,
        peng.M, u=uq, mode=precision)
    assert np.array_equal(echo.numpy(), np.asarray(jecho))
    assert np.array_equal(echo.numpy()[:len(codes)], codes)
    assert_mins(mins.numpy(), jm, precision, pre_max, cross_max)
    before = build.launch_counts()
    m2, e2 = peng.scan(qop, uq)                  # CPU: the plain version
    assert build.launch_counts() == before
    assert torch.equal(m2, mins) and torch.equal(e2, echo)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_gist_codes_mins_matches_jax_kernel(gist_setup, precision):
    cw, codes, queries = gist_setup
    jeng = jfused.FusedCodesEngine(cw, codes, precision=precision)
    peng = pfused.FusedCodesEngine(cw, codes, precision=precision,
                                   device=CPU)
    _same_codebook(peng, jeng, precision)
    jq, ju, qop, uq = _operands(jeng, queries, precision)
    jm, _ = jfp.fused_codes_mins(jq, jeng.cwbd, jeng.codes,
                                 jnp.int32(jeng.n_valid), u=ju,
                                 int16=precision == "int16")
    mins, _, pre_max, cross_max = fk.fused_codes_mins_ref(
        qop, peng.cwbd, peng.codes, peng.n_valid, u=uq, mode=precision)
    assert_mins(mins.numpy(), jm, precision, pre_max, cross_max)
    assert torch.equal(peng.scan(qop, uq)[0], mins)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_gist_delta_mins_matches_jax_kernel(gist_setup, precision):
    cw, codes, queries = gist_setup
    jeng = jfused.FusedCompressedEngine(cw, codes, precision=precision,
                                        fmt="slots")
    assert jeng.tiles.n_planes == 2
    peng = pfused.FusedCompressedEngine(cw, codes, precision=precision,
                                        fmt="slots", device=CPU)
    assert (peng.tiles.S, peng.tiles.Cap) == (jeng.tiles.S, jeng.tiles.Cap)
    assert np.array_equal(peng.tiles.row_data, jeng.tiles.row_data)
    assert np.array_equal(peng.tiles.ovf, jeng.tiles.ovf)
    jq, ju, qop, uq = _operands(jeng, queries, precision)
    jm, jecho = jfp.fused_delta_mins(
        jq, jeng.cwbd, jeng.row_data, jeng.ovf, jnp.int32(jeng.n_valid),
        jeng.tiles.S, u=ju, int16=precision == "int16")
    mins, echo, pre_max, cross_max = fk.fused_delta_mins_ref(
        qop, peng.cwbd, peng.row_data, peng.ovf, peng.n_valid, peng.tiles.S,
        u=uq, mode=precision)
    assert np.array_equal(echo.numpy(), np.asarray(jecho))
    assert_mins(mins.numpy(), jm, precision, pre_max, cross_max)
    assert torch.equal(peng.scan(qop, uq)[0], mins)


def test_gist_decoded_mins_matches_jax_kernel(gist_setup):
    """D pads 960 -> 1024 in the decoded cache."""
    cw, codes, queries = gist_setup
    peng = pfused.FusedDecodedEngine(cw, codes, device=CPU)
    assert peng.d_pad == 1024 and peng.xt.shape[2] == 1024
    q, _ = pfused._pad_queries(queries, peng.d_pad)
    qc = q - peng.mu[None, :]
    qop, uq, _ = peng._query_operands(qc)
    jq = jnp.asarray(qc.astype(jnp.bfloat16).T)
    assert np.array_equal(qop.view(torch.int16).numpy(),
                          np.asarray(jq).view(np.int16))
    jxt = jnp.asarray(peng.xt.view(torch.int16).numpy()).view(jnp.bfloat16)
    jm = jfp.fused_decoded_mins(jq, jxt, jnp.int32(len(codes)))
    mins, pre_max, cross_max = fk.fused_decoded_mins_ref(qop, peng.xt,
                                                         len(codes))
    assert_mins(mins.numpy(), jm, "bf16", pre_max, cross_max)
    assert torch.equal(peng.scan(qop, uq)[0], mins)


def _check_engine(peng, jeng, codes_scan, queries, top_k):
    jd, ji = jeng.query(queries, top_k=top_k)
    d, i = peng.query(queries, top_k=top_k)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)
    table = peng.prepare(queries)[0][:len(queries)].numpy()
    assert_ids_carry_dists(table, codes_scan, d, i)
    assert_ids_up_to_ties(table, codes_scan, i, np.asarray(ji), top_k)


ENGINES = {
    "decoded": lambda pkg, cw, codes, dev: pkg.FusedDecodedEngine(
        cw, codes, **dev),
    "codes": lambda pkg, cw, codes, dev: pkg.FusedCodesEngine(
        cw, codes, **dev),
    "stream": lambda pkg, cw, codes, dev: pkg.FusedCompressedEngine(
        cw, codes, precision="bf16", **dev),
    "stream-int16": lambda pkg, cw, codes, dev: pkg.FusedCompressedEngine(
        cw, codes, precision="int16", **dev),
    "stream-int8": lambda pkg, cw, codes, dev: pkg.FusedCompressedEngine(
        cw, codes, precision="int8", **dev),
    "slots": lambda pkg, cw, codes, dev: pkg.FusedCompressedEngine(
        cw, codes, precision="bf16", fmt="slots", **dev),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_gist_engine_matches_jax_engine(gist_setup, name):
    """The four engines (the compressed one in its three precisions) at
    top-100 and top-10."""
    cw, codes, queries = gist_setup
    jeng = ENGINES[name](jfused, cw, codes, {})
    peng = ENGINES[name](pfused, cw, codes, dict(device=CPU))
    for top_k in (100, 10):
        _check_engine(peng, jeng, codes, queries, top_k)


@pytest.mark.parametrize("top_k", [100, 10])
def test_gist_index_matches_jax_index(gist_setup, top_k):
    cw, codes, queries = gist_setup
    jidx = JIndex(cw, codes, engine="fused_compressed", build_tree=False)
    idx = DeltaPQIndex(cw, codes, engine="fused_compressed",
                       build_tree=False, device=CPU)
    jd, ji = jidx.search(queries, top_k=top_k)
    d, i = idx.search(queries, top_k=top_k)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)
    table = adc_table(torch.from_numpy(cw), torch.from_numpy(queries)
                      ).numpy()
    assert_ids_carry_dists(table, codes, d, i)
    assert_ids_up_to_ties(table, codes, i, np.asarray(ji), top_k)
    assert idx.stats() == jidx.stats()


# ---- the pipelined stream kernel's wrapper ---------------------------------

@pytest.fixture(scope="module")
def narrow_setup():
    rng = np.random.default_rng(21)
    M, K, Ds, n, B = 8, 32, 4, 3000, 16
    cw = (rng.normal(size=(M, K, Ds)) * 3).astype(np.float32)
    base = rng.integers(0, K, size=(n, M))
    codes = np.repeat(base, 4, axis=0)[:n].astype(np.uint8)
    queries = rng.normal(size=(B, M * Ds)).astype(np.float32)
    return cw, codes, queries


@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_pipelined_stream_mins_matches_jax(narrow_setup, precision):
    """``pipelined=True`` computes the stream kernel's function: equal to
    the JAX ``fused_stream_mins`` (which runs its serial kernel in
    interpret mode) and to the port's own serial call."""
    cw, codes, queries = narrow_setup
    jeng = jfused.FusedCompressedEngine(cw, codes, precision=precision)
    peng = pfused.FusedCompressedEngine(cw, codes, precision=precision,
                                        device=CPU, pipelined=True)
    assert peng.pipelined
    jq, ju, qop, uq = _operands(jeng, queries, precision)
    jm, jecho = jfp.fused_stream_mins(
        jq, jeng.cwbd, jeng.row_data, jeng.vals, jeng.meta,
        jnp.int32(jeng.n_valid), jeng.tiles.e_max, jeng.M, u=ju)
    args = (qop, peng.cwbd, peng.row_data, peng.vals, peng.meta,
            peng.n_valid, peng.M)
    mins, echo, pre_max, cross_max = fk.fused_stream_mins_ref(
        *args, u=uq, mode=precision, pipelined=True)
    assert np.array_equal(echo.numpy(), np.asarray(jecho))
    assert_mins(mins.numpy(), jm, precision, pre_max, cross_max)
    m1, e1 = fk.fused_stream_mins(*args, u=uq, mode=precision)
    before = build.launch_counts()
    m7, e7 = peng.scan(qop, uq)
    assert build.launch_counts() == before
    assert torch.equal(m7, m1) and torch.equal(e7, e1)
    assert torch.equal(m7, mins)
    d, i = peng.query(queries, top_k=10)
    jd, _ = jeng.query(queries, top_k=10)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)


def test_pipelined_refuses_int16_and_two_groups(narrow_setup, gist_setup):
    cw, codes, queries = narrow_setup
    e16 = pfused.FusedCompressedEngine(cw, codes, precision="int16",
                                       device=CPU)
    _, qop, uq, _, _ = e16.prepare(queries)
    with pytest.raises(NotImplementedError):
        fk.fused_stream_mins(qop, e16.cwbd, e16.row_data, e16.vals, e16.meta,
                             e16.n_valid, e16.M, u=uq, mode="int16",
                             pipelined=True)
    cw16, codes16, q16 = gist_setup
    g = pfused.FusedCompressedEngine(cw16, codes16, precision="int8",
                                     device=CPU)
    _, qop, uq, _, _ = g.prepare(q16)
    with pytest.raises(NotImplementedError):
        fk.fused_stream_mins(qop, g.cwbd, g.row_data, g.vals, g.meta,
                             g.n_valid, g.M, u=uq, mode="int8",
                             pipelined=True)
    for kw in (dict(precision="int16"), dict(precision="int8", fmt="slots")):
        with pytest.raises(NotImplementedError):
            pfused.FusedCompressedEngine(cw, codes, device=CPU,
                                         pipelined=True, **kw)
    with pytest.raises(NotImplementedError):
        pfused.FusedCompressedEngine(cw16, codes16, precision="int8",
                                     device=CPU, pipelined=True)


# ---- the workload and the files --------------------------------------------

def test_gist_vectors_equal_the_recipe():
    """``gist_vectors`` draws its noise in row chunks; the values are the
    one-call recipe's of tools/bench_gist.py for the same seed."""
    n, D, n_clusters, seed = 700, 960, 48, 5
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, D)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, size=n)
    want = (centers[assign]
            + rng.normal(size=(n, D)).astype(np.float32) * 0.35)
    for chunk in (128, 700, 65536):
        got = synth.gist_vectors(n, D, n_clusters, seed=seed,
                                 chunk_rows=chunk)
        assert got.dtype == np.float32 and np.array_equal(got, want)


def test_make_gist_workload_small():
    cw, codes, x = synth.make_gist_workload(600, M=16, K=16, Ds=60,
                                            n_clusters=32, seed=3,
                                            device=CPU, n_train=400)
    assert cw.shape == (16, 16, 60) and cw.dtype == np.float32
    assert codes.shape == (600, 16) and codes.dtype == np.uint8
    assert np.array_equal(x, synth.gist_vectors(600, 960, 32, seed=3))
    # every row's code is its nearest codeword in every subspace
    xs = x.reshape(600, 16, 60)
    d2 = ((xs[:, :, None, :] - cw[None]) ** 2).sum(-1)
    assert np.mean(d2.argmin(-1) == codes) > 0.999


@pytest.mark.parametrize("fmt", ["stream", "slots"])
def test_jax_m16_engine_file_loads_in_port(gist_setup, tmp_path, fmt):
    cw, codes, queries = gist_setup
    jeng = jfused.FusedCompressedEngine(cw, codes, fmt=fmt)
    path = str(tmp_path / f"jax_{fmt}.npz")
    jeng.save(path)
    peng = load_jax_engine(path, precision="bf16", device=CPU)
    assert peng.fmt == fmt and peng.M == 16
    assert peng.row_data.shape[1] == 2 + (jeng.tiles.S if fmt == "slots"
                                          else 0)
    _check_engine(peng, jeng, codes, queries, 100)
    # at the port's default precision too
    d16, _ = load_jax_engine(path, device=CPU).query(queries, top_k=100)
    assert np.array_equal(d16, peng.query(queries, top_k=100)[0])


def test_jax_m16_index_dir_loads_in_port(gist_setup, tmp_path):
    cw, codes, queries = gist_setup
    jidx = JIndex(cw, codes[:1500], engine="fused_compressed")
    path = str(tmp_path / "jax_idx16")
    jidx.save(path)
    idx = load_jax_index(path, device=CPU)
    assert idx.engine == "fused_compressed" and idx.M == 16
    assert idx._stream is None                   # no DTC stream at M=16
    jd, ji = JIndex.load(path).search(queries, top_k=100)
    d, i = idx.search(queries, top_k=100)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)
    table = adc_table(torch.from_numpy(cw), torch.from_numpy(queries)
                      ).numpy()
    assert_ids_up_to_ties(table, codes[:1500], i, np.asarray(ji), 100)
