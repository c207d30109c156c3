"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.

This file imports no jax, so on a GPU host without jax it runs as
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from deltapq_tpu_torch.ops import fused as pfused
from deltapq_tpu_torch.ops import fused_kernels as fk
from deltapq_tpu_torch.ops.adc import adc_query_topk, pad_codes
from deltapq_tpu_torch.ops.fused import FusedCompressedEngine
from deltapq_tpu_torch.ops.stream_tiles import decode_stream_tiles

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
    table, qop, uq, eq, b = eng.prepare(q)
    before = fk.launch_counts()["stream_mins"]
    mins, codes = eng.scan(qop, uq)
    torch.cuda.synchronize()
    assert fk.launch_counts()["stream_mins"] == before + 1
    ref_m, ref_c, pre_max, cross_max = fk.fused_stream_mins_ref(
        qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid,
        M, u=uq)
    assert torch.equal(codes, ref_c)
    tol = 4e-6 * (pre_max + 2 * cross_max)
    fin = torch.isfinite(ref_m)
    assert torch.equal(fin, torch.isfinite(mins))
    assert float((mins[fin] - ref_m[fin]).abs().max()) <= tol


@pytest.mark.parametrize("B,M,K,S", [(64, 8, 256, 5000), (8, 4, 32, 65536),
                                     (3, 8, 16, 1)])
def test_rerank_kernel_bit_equal(cuda, B, M, K, S):
    g = torch.Generator(device=cuda).manual_seed(S)
    tab = torch.randn((B, M * K), generator=g, device=cuda) * 100
    cand = torch.randint(0, K, (B, M, S), generator=g, device=cuda,
                         dtype=torch.uint8)
    out = fk.rerank_table_sums(tab, cand)
    assert torch.equal(out, fk.rerank_table_sums_ref(tab, cand))


def test_engine_exact_on_card(cuda):
    rng = np.random.default_rng(5)
    n, M, K, Ds = 20000, 8, 256, 16
    eng = _engine(rng, n, M, K, Ds, cuda)
    q = rng.normal(size=(300, M * Ds)).astype(np.float32) * 3
    fk.reset_launch_counts()
    d, i = eng.query(q, top_k=10)
    counts = fk.launch_counts()
    assert counts["stream_mins"] == 1 and counts["rerank"] >= 1
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
    table, qop, uq, eq, b = eng.prepare(q)
    mins, echo = eng.scan(qop, uq)
    q2, err_r, scale2 = pfused._quantized_query_stats(eng, qop, uq, eq)
    fk.reset_launch_counts()
    d, rows, ok, ok1 = pfused.fused_select_esc(
        mins, q2, table, echo, eng.n_valid, 10, (1, 2, 4), 1,
        err_r=err_r, scale2=scale2, final_exact=True)
    assert fk.launch_counts()["rerank"] == 3
    assert not bool(ok.all())                # the terminal scan ran
    dr, _ = adc_query_topk(table, echo, eng.n_valid, 10, 1024)
    assert torch.equal(d, dr)
    assert torch.equal(_own_dists(table, echo, rows), d)

    eng.ns_hint = 1
    de, _ = eng.query(q, top_k=10)
    assert eng.last_exact_frac < 1.0         # the first rung failed
    assert np.array_equal(de, dr[:b].cpu().numpy())
