"""The bf16 prepare of the fused engines: the plain version of
``csrc/prepare.cu`` (``fused_prepare_ref``) against the engines' host
path, and the route that picks one or the other.  The kernel itself runs
only on a card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltapq_tpu.ops import fused as jfused
from deltapq_tpu.ops import fused_pallas as jfp
from deltapq_tpu.ops.adc import adc_table as j_adc_table
from deltapq_tpu_torch import tracing
from deltapq_tpu_torch.kernels import build
from deltapq_tpu_torch.ops import fused as pfused
from deltapq_tpu_torch.ops import fused_kernels as fk
from deltapq_tpu_torch.ops.fused import FusedCodesEngine, FusedDecodedEngine

from _torch_port import CPU, codebook, structured_codes

#: (M, K, Ds): SIFT1M's shape, GIST1M's (two groups, d_pad 1024), and a
#: subspace wider than the kernel stages at once (two column chunks)
SHAPES = {"sift": (8, 256, 16), "gist": (16, 256, 60), "wide": (2, 256, 200)}
BATCHES = (1, 100, 300, 500, 512)
N = 2000

_engines = {}


def _engine(shape, kind, precision="bf16"):
    """A CPU engine over random codes, one a (shape, kind, precision)."""
    key = (shape, kind, precision)
    if key not in _engines:
        M, K, Ds = SHAPES[shape]
        rng = np.random.default_rng(M * Ds)
        cw = codebook(rng, M, K, Ds)
        codes = structured_codes(rng, N, M, K)
        _engines[key] = (
            FusedDecodedEngine(cw, codes, tile=1024, device=CPU)
            if kind == "decoded" else
            FusedCodesEngine(cw, codes, precision=precision, device=CPU))
    return _engines[key]


def _queries(eng, b, cols=None, seed=0):
    rng = np.random.default_rng(seed + b)
    return (rng.normal(size=(b, cols or eng.D)) * 3 + 1).astype(np.float32)


@pytest.mark.parametrize("kind", ["codes", "decoded"])
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_prepare_ref_equals_host_path(shape, b, kind):
    """qop and q2 bit-equal to the host path's, the table to its
    ``adc_table``, padding rows and columns included; and to the JAX
    package on the same inputs: qop bit for bit (its engines' bf16
    operand: the grouped layout for the codes tier, the plain one for the
    decoded tier), the table and q2 within the tolerance of the
    frameworks' f32 sums."""
    eng = _engine(shape, kind)
    q = _queries(eng, b)
    t_h, qop_h, uq_h, (q2_h, err_r, scale2), b_h = eng._prepare_on_host(q)
    assert uq_h is None and err_r is None and scale2 is None and b_h == b
    t, qop, q2 = fk.fused_prepare_ref(
        torch.from_numpy(q), eng.codewords, torch.from_numpy(eng.mu),
        -(-b // 128) * 128, eng._operand_layout())
    assert qop.dtype == torch.bfloat16 and qop.shape == qop_h.shape
    assert torch.equal(qop.view(torch.int16), qop_h.view(torch.int16))
    assert torch.equal(q2, q2_h)
    assert torch.equal(t, t_h)

    qj, _ = jfused._pad_queries(q, eng.d_pad)
    qc = qj - eng.mu[None]
    if kind == "codes":
        qc = jfp.pack_query_grouped(qc[:, :eng.D], eng.M, eng.Ds)
    jq = jfused._mins_query_args(qc, "bf16", None)[0]
    assert np.array_equal(qop.view(torch.int16).numpy(),
                          np.asarray(jq).view(np.int16))
    jt = np.asarray(j_adc_table(jnp.asarray(eng.codewords.numpy()),
                                jnp.asarray(qj[:, :eng.D])))
    np.testing.assert_allclose(t.numpy(), jt, rtol=1e-5, atol=1e-4)
    jc = qj - eng.mu[None]
    np.testing.assert_allclose(q2.numpy(),
                               np.asarray(jnp.sum(jc * jc, axis=1)),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_prepare_ref_narrow_queries(shape):
    """A batch narrower than D reads as the host's zero padding."""
    eng = _engine(shape, "codes")
    q = _queries(eng, 37, cols=eng.D - 5)
    t_h, qop_h, _, (q2_h, _, _), _ = eng._prepare_on_host(q)
    t, qop, q2 = fk.fused_prepare(torch.from_numpy(q), eng.codewords,
                                  torch.from_numpy(eng.mu), 128,
                                  eng._operand_layout())
    assert torch.equal(qop.view(torch.int16), qop_h.view(torch.int16))
    assert torch.equal(q2, q2_h) and torch.equal(t, t_h)


def _recorded_route(monkeypatch, eng, device):
    """Which of the two prepares ``eng.prepare`` calls on ``device``."""
    taken = []
    monkeypatch.setattr(eng, "device", torch.device(device))
    monkeypatch.setattr(eng, "_prepare_on_card",
                        lambda q: taken.append("card"))
    monkeypatch.setattr(eng, "_prepare_on_host",
                        lambda q: taken.append("host"))
    eng.prepare(np.zeros((4, eng.D), np.float32))
    return taken


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("precision,kind", [("bf16", "codes"),
                                            ("bf16", "decoded"),
                                            ("int8", "codes"),
                                            ("int16", "codes")])
def test_prepare_route(monkeypatch, precision, kind, device):
    """bf16 on a CUDA device takes the kernel; int8, int16 and the CPU
    keep the host path."""
    eng = _engine("sift", kind, precision)
    want = "card" if (device, precision) == ("cuda", "bf16") else "host"
    assert _recorded_route(monkeypatch, eng, device) == [want]


def test_prepare_route_wide_subspace(monkeypatch):
    """A subspace wider than the kernel stages at once takes the kernel
    too: the route reads only the device and the precision."""
    eng = _engine("wide", "codes")
    assert _recorded_route(monkeypatch, eng, "cuda") == ["card"]


@pytest.mark.parametrize("precision,kind", [("bf16", "codes"),
                                            ("bf16", "decoded"),
                                            ("int8", "codes"),
                                            ("int16", "codes")])
def test_card_centre_only_where_prepared(precision, kind):
    """``mu_dev`` (the kernel's centre on the card) is held only by a bf16
    engine on a CUDA device; a CPU engine holds none."""
    eng = _engine("sift", kind, precision)
    assert eng.mu_dev is None


@pytest.mark.parametrize("kind", ["codes", "decoded"])
@pytest.mark.parametrize("b", [1, 300, 512])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_card_route_plumbing(monkeypatch, shape, b, kind):
    """The card route with its pinned copy replaced by a plain tensor,
    so the plain version runs: one copy of B*D*4 bytes, no launch, and the
    host path's tuple bit for bit."""
    eng = _engine(shape, kind)
    q = _queries(eng, b, seed=7)
    monkeypatch.setattr(pfused, "_pinned_batch",
                        lambda a: torch.from_numpy(np.asarray(a, np.float32)))
    # the centre a bf16 engine on a card holds
    monkeypatch.setattr(eng, "mu_dev", torch.from_numpy(eng.mu))
    host = eng._prepare_on_host(q)
    build.reset_launch_counts()
    table, qop, uq, (q2, err_r, scale2), b_c = eng._prepare_on_card(q)
    counters = tracing.snapshot()["counters"]
    assert counters["h2d_bytes"] == b * eng.D * 4
    assert build.launch_counts()["prepare"] == 0
    assert uq is None and err_r is None and scale2 is None and b_c == b
    assert torch.equal(table, host[0]) and torch.equal(q2, host[3][0])
    assert torch.equal(qop.view(torch.int16), host[1].view(torch.int16))


def test_host_route_counts_no_launch():
    """The host path on the CPU: three copies, no prepare launch."""
    eng = _engine("sift", "codes")
    build.reset_launch_counts()
    eng.prepare(_queries(eng, 100))
    assert build.launch_counts()["prepare"] == 0
    # the table's queries, the bf16 operand, q2's queries
    assert tracing.snapshot()["counters"]["h2d_bytes"] == 128 * eng.D * 10


def test_pinned_batch_takes_a_matrix():
    with pytest.raises(ValueError):
        pfused._pinned_batch(np.zeros(8, np.float32))
