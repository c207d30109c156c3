"""Host-side operands of the tensor-core wide scan tail (the codes and
slot-tile kernels at M > 8 or M*Ds > 128, ``csrc/wide_mma.cuh``): the
padded codebook and the padded transposed queries against the compact
codebook and the grouped query operand they are made from, and their
product against the plain scan.  The kernels run only on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from deltapq_tpu_torch.ops import fused_kernels as fk
from deltapq_tpu_torch.ops.fused import _mins_query_args

MODES = ["int8", "int16", "bf16"]
SHAPES = [(M, Ds) for M in (12, 16) for Ds in (4, 8, 24, 60)]


def _operands(mode, M, Ds, K=16, B=5, seed=0):
    """(cwbd, q [planes*G*Dg, B], u [B] f32) of an engine in ``mode``,
    made as the engines make them (no centering)."""
    rng = np.random.default_rng(seed + 100 * M + Ds)
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32) * 3
    if mode == "bf16":
        cwbd, scale = fk.build_blockdiag_codebook(cw), None
    else:
        quant = (fk.quantize_blockdiag_int8 if mode == "int8"
                 else fk.quantize_blockdiag_int16)
        cwq, scale = quant(cw)
        cwbd = torch.from_numpy(cwq)
    qc = rng.normal(size=(B, M * Ds)).astype(np.float32) * 3
    q, u, _ = _mins_query_args(fk.pack_query_grouped(qc, M, Ds), mode,
                               scale, torch.device("cpu"))
    u = torch.ones(B) if u is None else u.reshape(-1)
    return cwbd, q, u


def _bytes(t):
    return t.contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("M,Ds", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_padded_codebook_holds_the_compact_words(mode, M, Ds):
    """Each codeword's bytes at the start of its SP-byte slot, zeros to
    the slot's end; SP a whole number of 16-byte pieces."""
    cwbd, _, _ = _operands(mode, M, Ds)
    cw, nrm, pad = fk.compact_codebook(cwbd, M, Ds, mode)
    assert pad is not None and pad.dtype == torch.uint8
    sp = fk.wide_sub_bytes(Ds, mode)
    sub = Ds * (2 if mode == "bf16" else 1)
    planes = 2 if mode == "int16" else 1
    K = nrm.shape[1]
    assert sp % 16 == 0 and sub <= sp < sub + 16
    assert tuple(pad.shape) == (planes, M, K, sp) and pad.is_contiguous()
    words = _bytes(cw).reshape(planes, M, K, sub)
    got = pad.numpy()
    assert np.array_equal(got[..., :sub], words)
    assert not got[..., sub:].any()


@pytest.mark.parametrize("M,Ds", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_padded_queries_hold_the_query_operand(mode, M, Ds):
    """Row b, plane p, subspace m of the padded transposed queries is
    column b of q at the subspace's rows of its group, then zeros."""
    _, q, _ = _operands(mode, M, Ds)
    qt = fk.pad_transpose_queries(q, M, Ds, mode)
    planes = 2 if mode == "int16" else 1
    G, Mg, Dg = fk.group_geometry(M, Ds)
    spv = fk.wide_sub_bytes(Ds, mode) // q.element_size()
    B = q.shape[1]
    assert qt.dtype == q.dtype and qt.is_contiguous()
    assert tuple(qt.shape) == (B, planes * M * spv)
    got = qt.reshape(B, planes, M, spv).to(torch.float32).numpy()
    qf = q.to(torch.float32).numpy()
    for p in range(planes):
        for m in range(M):
            row = p * G * Dg + (m // Mg) * Dg + (m % Mg) * Ds
            assert np.array_equal(got[:, p, m, :Ds], qf[row:row + Ds].T)
    assert not got[..., Ds:].any()


def _padded_products(pad, qt, codes, mode, M, Ds):
    """f64 products of x^ rows gathered from the padded codebook by the
    codes with the padded queries, as the wide tail forms them: [planes
    of x^, planes of q, n, B]."""
    planes = 2 if mode == "int16" else 1
    sp = fk.wide_sub_bytes(Ds, mode)
    m = np.arange(M)
    rows = pad.numpy()[:, m[None, :], codes.numpy().astype(np.int64)]
    rows = np.ascontiguousarray(rows).reshape(planes, len(codes), M * sp)
    if mode == "bf16":
        x = torch.from_numpy(rows).view(torch.bfloat16).to(torch.float64)
        qf = qt.to(torch.float64).reshape(qt.shape[0], 1, -1)
    else:
        x = torch.from_numpy(rows.view(np.int8)).to(torch.float64)
        qf = qt.to(torch.float64).reshape(qt.shape[0], planes, -1)
    return torch.einsum("pnd,bqd->pqnb", x, qf)


def _blockdiag_cross(cwbd, q, codes, M, mode):
    """The same products through the block-diagonal codebook and the
    grouped query operand, as the plain scan decodes (in f64)."""
    G, Mg, _ = fk.group_geometry(M, 1)
    K = fk._codebook_k(cwbd, M)
    width = cwbd.shape[1]
    bd = cwbd.to(torch.float64).reshape(G * Mg, K, width)
    c = codes.to(torch.int64)
    x = torch.cat([bd[torch.arange(g * Mg, min((g + 1) * Mg, M))[None, :],
                      c[:, g * Mg:(g + 1) * Mg]].sum(dim=1)
                   for g in range(G)], dim=1)
    qf = q.to(torch.float64)
    if mode != "int16":
        return x @ qf
    Dg = width // 2
    xa = torch.cat([x[:, g * width:g * width + Dg] for g in range(G)], 1)
    xb = torch.cat([x[:, g * width + Dg:(g + 1) * width] for g in range(G)],
                   1)
    qa, qb = qf[:G * Dg], qf[G * Dg:]
    return xa @ qa, xa @ qb + xb @ qa, xb @ qb


PRODUCT_SHAPES = [(12, 8), (16, 60), (8, 24), (16, 4)]


@pytest.mark.parametrize("M,Ds", PRODUCT_SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_padded_product_equals_the_blockdiag_cross(mode, M, Ds):
    """The padding meets zeros on both sides, so the product of the
    padded operands is the plain scan's cross (int16: aa, p2, bb), exact
    in f64."""
    cwbd, q, _ = _operands(mode, M, Ds)
    _, _, pad = fk.compact_codebook(cwbd, M, Ds, mode)
    qt = fk.pad_transpose_queries(q, M, Ds, mode)
    K = fk._codebook_k(cwbd, M)
    rng = np.random.default_rng(M + Ds)
    codes = torch.from_numpy(rng.integers(0, K, size=(96, M))
                             .astype(np.uint8))
    prod = _padded_products(pad, qt, codes, mode, M, Ds)
    ref = _blockdiag_cross(cwbd, q, codes, M, mode)
    if mode == "int16":
        aa, p2, bb = ref
        assert torch.equal(prod[0, 0], aa) and torch.equal(prod[1, 1], bb)
        assert torch.equal(prod[0, 1] + prod[1, 0], p2)
    else:
        assert torch.equal(prod[0, 0], ref)


@pytest.mark.parametrize("M,Ds", PRODUCT_SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_padded_product_gives_the_plain_mins(mode, M, Ds):
    """The wide tail's arithmetic on the padded product (pre from the
    norm tables summed over ascending m, the f32 epilogue of the scan
    tails) against ``_scan_tail_ref``: int8 bit-equal,
    int16 within 4e-6 (max pre + 2 max|u*cross|) (the plain version sums
    pre in f32), bf16 within 2e-5 (max pre + 2 sqrt(max pre) max ||q||)
    (f32 sums in another order)."""
    cwbd, q, u = _operands(mode, M, Ds)
    _, nrm, pad = fk.compact_codebook(cwbd, M, Ds, mode)
    qt = fk.pad_transpose_queries(q, M, Ds, mode)
    K = fk._codebook_k(cwbd, M)
    n, n_valid = 96, 90
    rng = np.random.default_rng(M * Ds)
    codes = torch.from_numpy(rng.integers(0, K, size=(n, M))
                             .astype(np.uint8))
    prod = _padded_products(pad, qt, codes, mode, M, Ds)
    c = codes.to(torch.int64)
    norms = nrm[torch.arange(M)[None, :], c]                  # [n, M]
    if mode == "bf16":
        pre = torch.zeros(n, dtype=torch.float32)
        for m in range(M):
            pre = pre + norms[:, m]
        cross = prod[0, 0].to(torch.float32)
    else:
        pre = norms.sum(dim=1).to(torch.float32)
        if mode == "int8":
            cross = prod[0, 0].to(torch.float32) * u
        else:
            aa, bb = prod[0, 0], prod[1, 1]
            p2 = prod[0, 1] + prod[1, 0]
            cross = ((16384.0 * aa.to(torch.float32)
                      + 128.0 * p2.to(torch.float32))
                     + bb.to(torch.float32)) * u
    d = pre[:, None] - 2.0 * cross
    d[n_valid:] = float("inf")
    mins = d.reshape(-1, fk.SUB, d.shape[1]).amin(dim=1)
    ref, pre_max, cross_max = fk._scan_tail_ref(codes, q, cwbd, n_valid, M,
                                                mode, u=u.reshape(1, -1))
    assert torch.equal(torch.isinf(mins), torch.isinf(ref))
    fin = torch.isfinite(ref)
    if mode == "int8":
        assert torch.equal(mins, ref)
    else:
        tol = (4e-6 if mode == "int16" else 2e-5) * (pre_max
                                                     + 2 * cross_max)
        assert float((mins[fin] - ref[fin]).abs().max()) <= tol


@pytest.mark.parametrize("mode", MODES)
def test_narrow_shapes_have_no_padded_codebook(mode):
    cwbd, _, _ = _operands(mode, 8, 16)
    _, _, pad = fk.compact_codebook(cwbd, 8, 16, mode)
    assert pad is None


@pytest.mark.parametrize("variant", sorted(
    __import__("deltapq_tpu_torch.kernels.ablate_wide",
               fromlist=["VARIANTS"]).VARIANTS))
def test_wide_ablation_variants_still_match_the_tail_source(variant):
    """Each ablation of the wide tail replaces text that is in
    ``wide_mma.cuh`` as often as it says, so a variant never silently
    equals the whole tail."""
    from deltapq_tpu_torch.kernels import ablate_wide, build
    src = (build.CSRC_DIR / "wide_mma.cuh").read_text()
    parts = ablate_wide.VARIANTS[variant]
    out = ablate_wide.variant_source(src, parts)
    assert (out == src) == (not parts)
    assert "struct WideMma" in out
