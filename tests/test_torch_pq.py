"""The port's PQ learn/encode and ADC against the JAX package's, on the
same NumPy inputs."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deltapq_tpu.ops import adc as jadc
from deltapq_tpu.ops.encode import pq_encode as j_encode
from deltapq_tpu_torch.ops import adc as padc
from deltapq_tpu_torch.ops import kmeans as pkm
from deltapq_tpu_torch.ops.encode import pq_decode, pq_encode
from deltapq_tpu import synth as jsynth
from deltapq_tpu_torch import synth as psynth
from deltapq_tpu_torch.synth import make_clustered_codes, workload_vectors

from _torch_port import CPU, assert_ids_up_to_ties, codebook, structured_codes

# the JAX package's ops/__init__ re-exports a function named ``kmeans``
jkm = importlib.import_module("deltapq_tpu.ops.kmeans")


@pytest.mark.parametrize("K", [16, 64])
def test_lloyd_step_matches_jax(small_dataset, K):
    """One Lloyd step (assign, update, reseed empties) from the same
    centres; K=64 on 32 clusters leaves clusters empty."""
    x = small_dataset[:, :8]
    rng = np.random.default_rng(K)
    c0 = x[rng.choice(len(x), K, replace=False)] + 100.0 * (
        np.arange(K)[:, None] >= K - 4)              # 4 far, empty centres
    c0 = c0.astype(np.float32)
    jd2 = jkm._pairwise_sq_dists(jnp.asarray(x), jnp.asarray(c0))
    jl = jnp.argmin(jd2, axis=1)
    jc, jn = jkm._update_centers(jnp.asarray(x), jl, K)
    jc = jkm._reseed_empty(jnp.asarray(x), jc, jn, jnp.min(jd2, axis=1))
    xt = torch.from_numpy(x)
    d2 = pkm._pairwise_sq_dists(xt, torch.from_numpy(c0))
    md2, lab = torch.min(d2, dim=1)
    assert np.array_equal(lab.numpy(), np.asarray(jl))
    c, n = pkm._update_centers(xt, lab, K)
    assert np.array_equal(n.numpy(), np.asarray(jn))
    assert (n.numpy() == 0).sum() >= 4
    c = pkm._reseed_empty(xt, c, n, md2)
    # sums of a few hundred f32 rows in another order: ulps
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)


def test_kmeans_converges_and_is_seeded(small_dataset):
    x = torch.from_numpy(small_dataset)
    g = lambda: torch.Generator().manual_seed(3)       # noqa: E731
    c1, l1, d1 = pkm.kmeans(g(), x, 32, max_iters=30, n_init=2)
    c2, _, d2 = pkm.kmeans(g(), x, 32, max_iters=30, n_init=2)
    assert torch.equal(c1, c2) and float(d1) == float(d2)
    assert l1.shape == (len(x),) and int(l1.max()) < 32
    # no worse than the JAX package's k-means on the same data
    _, _, jd = jkm.kmeans(jax.random.PRNGKey(1), small_dataset, 32,
                          max_iters=30)
    assert float(d1) <= 1.25 * float(jd)


@pytest.mark.parametrize("M,K,Ds", [(8, 256, 4), (4, 32, 4)])
def test_pq_encode_exact_up_to_ties(M, K, Ds):
    rng = np.random.default_rng(M + K)
    cw = codebook(rng, M, K, Ds)
    x = rng.normal(size=(3000, M * Ds)).astype(np.float32) * 3
    want = np.asarray(j_encode(cw, x))
    got = pq_encode(torch.from_numpy(cw), x, batch_size=1000).numpy()
    assert got.dtype == np.uint8
    for i, m in zip(*np.nonzero(got != want)):
        sub = x[i, m * Ds:(m + 1) * Ds]
        da = np.sum((sub - cw[m, got[i, m]]) ** 2)
        db = np.sum((sub - cw[m, want[i, m]]) ** 2)
        assert abs(da - db) < 1e-4 * max(da, 1.0)
    assert (got != want).any(axis=1).mean() < 1e-3
    dec = pq_decode(torch.from_numpy(cw), torch.from_numpy(got)).numpy()
    assert np.array_equal(dec[:, :Ds], cw[0][got[:, 0]])


@pytest.mark.parametrize("M,K,Ds", [(8, 256, 4), (4, 32, 4)])
def test_adc_table_and_scan_match_jax(M, K, Ds):
    rng = np.random.default_rng(2 * M + K)
    cw = codebook(rng, M, K, Ds)
    codes = structured_codes(rng, 3000, M, K)
    q = rng.normal(size=(64, M * Ds)).astype(np.float32) * 3
    jt = np.asarray(jadc.adc_table(jnp.asarray(cw), jnp.asarray(q)))
    pt = padc.adc_table(torch.from_numpy(cw), torch.from_numpy(q))
    np.testing.assert_allclose(pt.numpy(), jt, rtol=1e-5, atol=1e-4)
    cp = padc.pad_codes(codes, 1024)
    jd, ji = jadc.adc_query_topk(jnp.asarray(jt), jnp.asarray(cp),
                                 jnp.int32(len(codes)), 10, 1024)
    jt = np.array(jt)
    d, i = padc.adc_query_topk(torch.from_numpy(jt), torch.from_numpy(cp),
                               len(codes), 10, 1024)
    # same table, same ascending-m f32 sums: bit-equal distances
    assert np.array_equal(d.numpy(), np.asarray(jd))
    assert_ids_up_to_ties(jt, codes, i.numpy(), np.asarray(ji), 10)
    tile = padc.adc_tile_dists(torch.from_numpy(jt),
                               torch.from_numpy(codes[:100]))
    assert np.array_equal(tile.numpy(), np.asarray(
        jadc.adc_tile_dists(jnp.asarray(jt), jnp.asarray(codes[:100]))))


def test_workload_recipe_is_the_benchmarks():
    """Same vectors as bench.py's make_clustered_codes recipe."""
    x = workload_vectors(4000, rows_per_cluster=8, sigma=0.8, seed=0)
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(500, 128)).astype(np.float32) * 4.0
    assign = rng.integers(0, 500, size=4000)
    want = centers[assign] + rng.normal(size=(4000, 128)).astype(
        np.float32) * 0.8
    assert np.array_equal(x, want)
    cw, codes = make_clustered_codes(4000, 8, 16, rows_per_cluster=8,
                                     sigma=0.8, n_train=1000, device=CPU)
    assert cw.shape == (8, 16, 16) and codes.shape == (4000, 8)
    assert codes.dtype == torch.uint8


def test_synth_generators_equal():
    assert np.array_equal(psynth.chain_codes(500, M=8, K=256, seed=4),
                          jsynth.chain_codes(500, M=8, K=256, seed=4))
    assert np.array_equal(
        psynth.clustered_vectors(700, 24, n_clusters=9, seed=2),
        jsynth.clustered_vectors(700, 24, n_clusters=9, seed=2))


def test_clustered_codes_is_the_engine_benchmarks_recipe():
    """``synth.clustered_codes`` draws what tools/bench_engines.py draws
    (a pool of max(N // 200, 16) codes, 15% of the bytes redrawn), from
    the same generator state."""
    N, M, K = 5000, 8, 256
    rng = np.random.default_rng(0)
    cw = rng.normal(size=(M, K, 16)).astype(np.float32)
    pool = rng.integers(0, K, size=(max(N // 200, 16), M))
    want = pool[rng.integers(0, len(pool), N)]
    mut = rng.random((N, M)) < 0.15
    want = np.where(mut, rng.integers(0, K, size=(N, M)),
                    want).astype(np.uint8)
    q = rng.normal(size=(4, M * 16)).astype(np.float32)

    from deltapq_tpu_torch.bench_engines import workload
    cw2, codes, q2 = workload(N, 4)
    assert np.array_equal(cw, cw2) and np.array_equal(q, q2)
    assert codes.dtype == np.uint8 and np.array_equal(codes, want)
    rng2 = np.random.default_rng(0)
    rng2.normal(size=(M, K, 16))
    assert np.array_equal(psynth.clustered_codes(N, M, K, rng=rng2), want)
    a = psynth.clustered_codes(300, 4, 16, seed=3)
    assert np.array_equal(a, psynth.clustered_codes(300, 4, 16, seed=3))
    assert a.shape == (300, 4) and a.max() < 16
