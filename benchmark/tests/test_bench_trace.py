"""The idle-share and roofline arithmetic on a synthetic trace."""

from types import SimpleNamespace

import pytest

from benchmark import roofline, run
from benchmark.tracing import SLICE, short_name, summarize

KERNEL = "void stream_mins_mma_kernel<MmaTail<1> >(void const*, int)"


def _events():
    # a 10 ms slice (us); two scans of 1 ms overlapping a copy, a
    # rerank, and host ranges over the gaps
    return [
        (SLICE, False, 1000.0, 11000.0),
        ("index.search", False, 1000.0, 6000.0),
        ("engine.prepare", False, 1000.0, 3000.0),
        ("aten::to", False, 2000.0, 2900.0),
        (KERNEL, True, 3000.0, 4000.0),
        ("Memcpy HtoD (Pageable -> Device)", True, 3500.0, 4500.0),
        ("rerank_kernel<unsigned char>", True, 5000.0, 5500.0),
        (KERNEL, True, 8000.0, 9000.0),
        ("index.search", False, 6000.0, 11000.0),
        # outside the slice: ignored
        (KERNEL, True, 12000.0, 13000.0),
    ]


def test_busy_union_gaps_and_ops():
    tr = summarize(_events())
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s == pytest.approx(0.0015 + 0.0005 + 0.001)
    kern = tr.device_ops[short_name(KERNEL)]
    assert kern == [pytest.approx(0.002), 2]
    assert [g[0] for g in tr.gaps] == pytest.approx(
        [0.0025, 0.002, 0.002, 0.0005])
    first = dict((round(s, 6), lab) for s, lab in tr.gaps)
    assert first[0.0025] == "index.search / index.search"
    assert any(lab == "engine.prepare / aten::to" for _, lab in tr.gaps)


def test_no_slice_no_trace():
    assert summarize([(KERNEL, True, 0.0, 1.0)]) is None


def _run(trace, **kw):
    cfg = dict(D=128, M=8, precision="float32", scan_precision="bf16")
    return SimpleNamespace(trace=trace, config=cfg,
                           traffic=dict(batch=512), n_rows=1_000_000,
                           counters={"scan_stream_bytes": 4_770_000},
                           **kw)


def test_idle_share_reader():
    tr = summarize(_events())
    got = run.reader("device_idle_share")(_run(tr))
    assert got == pytest.approx(100 * (1 - 0.003 / 0.010))
    assert run.reader("device_idle_share.serve")(_run(tr)) == got
    assert run.reader("device_idle_share")(_run(None)) is None


def test_scan_roofline_reader():
    tr = summarize(_events())
    least = 2.0 * 1_000_000 * 512 * 128 / 989e12          # ops-bound
    nbytes = roofline.scan_bytes(4_770_000, 1_000_000, 512, 128, 8)
    assert nbytes == 4_770_000 + 2 * 512 * 128 + 4 * 512 * 31250 + 8e6
    assert nbytes / roofline.HBM_BPS < least
    got = run.reader("scan_roofline")(_run(tr))
    assert got == pytest.approx(100 * least / 0.001)
    none = summarize([(SLICE, False, 0.0, 10.0),
                      ("rerank_kernel", True, 1.0, 2.0)])
    assert run.reader("scan_roofline")(_run(none)) is None
    unread = _run(tr)
    unread.counters = {}
    assert run.reader("scan_roofline")(unread) is None


def test_bound_by_bytes_or_operations():
    assert roofline.bound_s(3.35e12, 1.0, "bf16") == (pytest.approx(1.0),
                                                      "bytes")
    assert roofline.bound_s(1.0, 989e12, "bf16") == (pytest.approx(1.0),
                                                     "operations")
    assert roofline.scan_ops(10, 2, 3, "int16") == 4 * 2 * 10 * 2 * 3


def test_events_drop_host_ranges_mirrored_on_the_device():
    from types import SimpleNamespace as NS

    import torch

    from benchmark.tracing import _events

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, dev, t0, t1):
        return NS(name=lambda: name, device_type=lambda: dev,
                  start_ns=lambda: t0, duration_ns=lambda: t1 - t0)

    raw = [ev(SLICE, cpu, 0, 10_000), ev("engine.scan", cpu, 0, 5_000),
           ev("engine.scan", cuda, 0, 5_000), ev(KERNEL, cuda, 1_000, 2_000)]
    prof = NS(profiler=NS(kineto_results=NS(events=lambda: raw)))
    got = _events(prof)
    assert [(n, d) for n, d, _, _ in got] == [
        (SLICE, False), ("engine.scan", False), (KERNEL, True)]
    assert got[2][2:] == (1.0, 2.0)
