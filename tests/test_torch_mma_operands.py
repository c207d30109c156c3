"""Host-side pieces of the tensor-core scan kernels: the transposed
query operands against the operand they are made from, the
shape rule that picks the narrow tails, and the scan benchmark's CPU
rehearsal.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from deltapq_tpu_torch import bench_stream
from deltapq_tpu_torch.ops import fused_kernels as fk
from deltapq_tpu_torch.ops.fused import (FusedCompressedEngine,
                                         FusedDecodedEngine)

from _torch_port import CPU


@pytest.mark.parametrize("B", [1, 7, 8, 200, 513])
def test_transpose_queries_of_the_decoded_operand(B):
    """q [D, B] bf16 -> [B, D]: row b is query b, contiguous."""
    g = torch.Generator().manual_seed(B)
    q = torch.randn((24, B), generator=g).to(torch.bfloat16)
    qt = fk.transpose_queries(q)
    assert qt.shape == (B, 24) and qt.dtype == q.dtype
    assert qt.is_contiguous()
    for b in {0, B // 2, B - 1}:
        assert torch.equal(qt[b], q[:, b])


@pytest.mark.parametrize("precision,planes", [("int16", 2), ("int8", 1),
                                              ("bf16", 1)])
def test_transpose_queries_lays_a_query_side_by_side(precision, planes):
    """Row b of the transposed operand is column b of the engine's query
    operand: at int16 the a-digits of the padded row, then its b-digits."""
    rng = np.random.default_rng(3)
    M, K, Ds, n = 4, 16, 4, 1500
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    codes = rng.integers(0, K, size=(n, M)).astype(np.uint8)
    eng = FusedCompressedEngine(cw, codes, precision=precision, device=CPU)
    q = rng.normal(size=(37, M * Ds)).astype(np.float32)
    _, qop, _, _, _ = eng.prepare(q)
    qt = fk.transpose_queries(qop)
    Dg = fk.group_geometry(M, Ds)[2]
    assert qt.shape == (qop.shape[1], planes * Dg) and qt.is_contiguous()
    assert qt.dtype == qop.dtype
    for b in (0, 5, 36):
        for p in range(planes):
            assert torch.equal(qt[b, p * Dg:(p + 1) * Dg],
                               qop[p * Dg:(p + 1) * Dg, b])
    # past the real dims the operand is zero: the kernels read whole
    # 16-byte pieces of a row
    assert not qt[:, M * Ds:Dg].to(torch.float32).any()


@pytest.mark.parametrize("M,Ds,narrow", [(8, 16, True), (4, 4, True),
                                         (8, 4, True), (4, 32, True),
                                         (8, 24, False), (16, 4, False),
                                         (16, 60, False), (12, 8, False)])
def test_narrow_shape_rule(M, Ds, narrow):
    assert fk.narrow_shape(M, Ds) is narrow


@pytest.mark.parametrize("kernel,M,Ds,form", [
    ("stream_mins", 8, 16, "mma"), ("stream_mins", 16, 60, "wgmma"),
    ("stream_mins", 8, 24, "wgmma"),
    ("codes_mins", 4, 32, "mma"), ("codes_mins", 16, 60, "wgmma"),
    ("codes_mins", 12, 8, "wgmma"),
    ("delta_mins", 8, 4, "mma"), ("delta_mins", 16, 4, "wgmma"),
    ("delta_mins", 8, 24, "wgmma"),
    ("stream_mins_pipelined", 8, 16, "cuda_cores")])
def test_scan_tail_form_rule(kernel, M, Ds, form):
    """The tail each scan kernel runs, by shape alone: B1, B3 and B5 on
    mma.sync at the narrow shapes and on the gathered wgmma tail at the
    wide ones; B7 on the CUDA cores.  The query operand follows the
    form."""
    assert fk.scan_tail_form(kernel, M, Ds) == form
    G, _, Dg = fk.group_geometry(M, Ds)
    q = torch.arange(G * Dg * 3, dtype=torch.int32).reshape(G * Dg, 3).to(
        torch.int8)
    if form == "cuda_cores":
        assert fk.scan_queries(kernel, q, M, Ds, "int8") is None
    elif form == "mma":
        assert torch.equal(fk.scan_queries(kernel, q, M, Ds, "int8"),
                           fk.transpose_queries(q))
    else:
        qt = fk.scan_queries(kernel, q, M, Ds, "int8")
        assert qt.shape == (3, M * fk.wide_sub_bytes(Ds, "int8"))


@pytest.mark.parametrize("mode", ["int16", "int8", "bf16"])
def test_stream_kernel_reads_the_padded_queries_at_gist(mode):
    """At the GIST shape (M=16, Ds=60) the stream kernel reads the wide
    tail's padded query operand in every mode, as the codes and slot-tile
    kernels do."""
    M, Ds = 16, 60
    G, _, Dg = fk.group_geometry(M, Ds)
    planes = 2 if mode == "int16" else 1
    g = torch.Generator().manual_seed(planes)
    q = torch.randint(-127, 128, (planes * G * Dg, 5), generator=g)
    q = q.to(torch.bfloat16 if mode == "bf16" else torch.int8)
    qt = fk.scan_queries("stream_mins", q, M, Ds, mode)
    assert torch.equal(qt, fk.pad_transpose_queries(q, M, Ds, mode))
    assert qt.shape == (5, planes * M * fk.wide_sub_bytes(Ds, mode)
                        // q.element_size())


def test_scan_tail_form_refuses_an_unknown_kernel():
    with pytest.raises(ValueError):
        fk.scan_tail_form("decoded_mins", 8, 16)


@pytest.mark.parametrize("B", [1, 13, 64])
def test_decoded_wrapper_on_the_cpu_takes_any_batch(B):
    rng = np.random.default_rng(B)
    M, K, Ds, n = 4, 16, 4, 700
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    codes = rng.integers(0, K, size=(n, M)).astype(np.uint8)
    eng = FusedDecodedEngine(cw, codes, tile=256, device=CPU)
    q = rng.normal(size=(B, M * Ds)).astype(np.float32)
    _, qop, _, _, b = eng.prepare(q)
    qop = qop[:, :b].contiguous()
    mins = fk.fused_decoded_mins(qop, eng.xt, n)
    ref, _, _ = fk.fused_decoded_mins_ref(qop, eng.xt, n)
    assert mins.shape == (eng.xt.shape[0] * 256 // 32, B)
    assert torch.equal(mins, ref)


def test_mm_yardstick_is_the_cross_product():
    g = torch.Generator().manual_seed(0)
    xt = torch.randn((2, 64, 16), generator=g).to(torch.bfloat16)
    q = torch.randn((16, 8), generator=g).to(torch.bfloat16)
    out = bench_stream.mm_yardstick(xt, q).to(torch.float32)
    ref = xt.reshape(-1, 16).to(torch.float32) @ q.to(torch.float32)
    assert out.shape == (128, 8)
    assert torch.allclose(out, ref, rtol=2e-2, atol=2e-2)


def test_bench_stream_rehearses_on_the_cpu(capsys):
    """The benchmark's whole flow with the plain versions: B1 equals B3
    bit for bit at int8 and int16 or it raises; no time is printed as a
    device time."""
    assert bench_stream.main(["2048", "16"], device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("B1 = B3 bit for bit") == 2
    assert "cpu (plain versions; no device time)" in out
    assert "nan ms" in out


def test_bench_stream_gist_form_rehearses_on_the_cpu(capsys):
    """The GIST form's flow with the plain versions: B1, B3 and B5 on the
    GIST-shape codes and B1 and B3 on the near-distinct set, equal bit for
    bit at int8 and int16 or it raises."""
    assert bench_stream.main(["gist", "4096", "16"], device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("B1 = B3 bit for bit") == 4
    assert out.count("B1 = B5 bit for bit") == 2
    assert "near-distinct set N=1024" in out


@pytest.mark.parametrize("variant", sorted(
    __import__("deltapq_tpu_torch.kernels.ablate_decoded",
               fromlist=["VARIANTS"]).VARIANTS))
def test_ablation_variants_still_match_the_kernel_source(variant):
    """Each ablation replaces lines that are in ``decoded_mins.cu``
    exactly once, so a variant never silently equals the whole kernel."""
    from deltapq_tpu_torch.kernels import ablate_decoded, build
    src = (build.CSRC_DIR / "decoded_mins.cu").read_text()
    parts = ablate_decoded.VARIANTS[variant]
    out = ablate_decoded.variant_source(src, parts)
    assert (out == src) == (not parts)
    assert "decoded_mins_launch" in out
