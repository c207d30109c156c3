"""The port's spans and counters (``deltapq_tpu_torch/tracing.py``): off
costs nothing and records nothing; on, self times add up; under
``torch.profiler`` the ranges carry the program's names; the counters the
engines, the ladder and the server keep; the benchmark's readers of
them."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.tracing import SLICE, summarize
from deltapq_tpu_torch import tracing
from deltapq_tpu_torch.index import DeltaPQIndex
from deltapq_tpu_torch.kernels import build
from deltapq_tpu_torch.ops import fused as pfused
from deltapq_tpu_torch.ops import fused_kernels as fk
from deltapq_tpu_torch.ops.adc import adc_query_topk
from deltapq_tpu_torch.ops.fused import (FusedCodesEngine,
                                         FusedCompressedEngine)
from deltapq_tpu_torch.parallel import ShardedCompressedEngine, make_mesh
from deltapq_tpu_torch.serving import CoalescingServer

from _torch_port import CPU, codebook, structured_codes

M, K, DS, N = 8, 32, 4, 4096


@pytest.fixture(autouse=True)
def clean_registry():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(16)
    cw = codebook(rng, M, K, DS)
    codes = structured_codes(rng, N, M, K)
    rows = codes[rng.integers(0, N, 100)]
    queries = (np.concatenate([cw[m][rows[:, m]] for m in range(M)], 1)
               + rng.normal(size=(100, M * DS)).astype(np.float32))
    return cw, codes, queries


class FakeClock:
    """``perf_counter_ns`` stand-in: each read advances by the next step."""

    def __init__(self, steps):
        self.t, self.steps = 0, list(steps)

    def __call__(self):
        self.t += self.steps.pop(0)
        return self.t


# -- the mechanism ----------------------------------------------------------

def test_span_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while off")

    monkeypatch.setattr(tracing.time, "perf_counter_ns", no_clock)
    a = tracing.span("engine.query")
    b = tracing.span("engine.prepare", ns=4)
    assert a is b                          # one shared no-op
    with a, b:
        pass
    assert tracing.snapshot()["spans"] == {}


def test_nested_self_time(monkeypatch):
    # entry/exit reads: outer in, inner in (+10), leaf in (+5), leaf out
    # (+20), inner out (+30), second child in (+1), out (+4), outer out (+7)
    clock = FakeClock([100, 10, 5, 20, 30, 1, 4, 7])
    monkeypatch.setattr(tracing.time, "perf_counter_ns", clock)
    tracing.enable()
    with tracing.span("index.search"):
        with tracing.span("engine.query"):
            with tracing.span("engine.wait"):
                pass
        with tracing.span("engine.wait"):
            pass
    spans = tracing.snapshot()["spans"]
    # outer 10+5+20+30+1+4+7 = 77; inner 5+20+30 = 55; waits 20 and 4
    assert spans["index.search"] == pytest.approx((1, 77e-9, (77 - 55 - 4)
                                                   * 1e-9))
    assert spans["engine.query"] == pytest.approx((1, 55e-9, 35e-9))
    assert spans["engine.wait"] == pytest.approx((2, 24e-9, 24e-9))


def test_call_ids_roots_and_children():
    tracing.enable()
    with tracing.span("index.search") as s1:
        with tracing.span("engine.query") as c1:
            assert c1.call == s1.call
    with tracing.span("index.search") as s2:
        pass
    assert s2.call != s1.call


def test_threads_keep_their_own_parents():
    tracing.enable()
    go = threading.Event()

    def worker():
        go.wait(5)
        with tracing.span("engine.query"):
            time.sleep(0.02)

    t = threading.Thread(target=worker)
    t.start()
    with tracing.span("index.search"):
        go.set()
        t.join(5)
    assert not t.is_alive()
    spans = tracing.snapshot()["spans"]
    # the other thread's span is no child of this one
    search = spans["index.search"]
    assert search[2] == pytest.approx(search[1])
    assert spans["engine.query"][0] == 1


def test_no_update_lost_across_threads():
    """More threads than cores, switching often: every count and span
    lands."""
    import sys

    tracing.enable()
    n_threads, n_each = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(n_each):
                tracing.count("rows_served", 2)
                with tracing.span("engine.query"):
                    with tracing.span("engine.wait"):
                        pass

        threads = [threading.Thread(target=worker)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = tracing.snapshot()
    assert snap["counters"]["rows_served"] == 2 * n_threads * n_each
    assert snap["spans"]["engine.query"][0] == n_threads * n_each
    assert snap["spans"]["engine.wait"][0] == n_threads * n_each


def test_disable_and_reset():
    tracing.enable()
    with tracing.span("engine.scan"):
        pass
    tracing.disable()
    with tracing.span("engine.scan"):
        pass
    tracing.count("h2d_bytes", 8)
    snap = tracing.snapshot()
    assert snap["spans"]["engine.scan"][0] == 1
    assert snap["counters"] == {"h2d_bytes": 8}   # counters stay on
    tracing.reset()
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def test_profiler_ranges_carry_program_names_and_nesting(data):
    cw, codes, queries = data
    eng = FusedCompressedEngine(cw, codes, precision="bf16", device=CPU)
    tracing.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.query(queries, top_k=10)
    ev = {}
    for e in prof.events():
        ev.setdefault(e.name, []).append(e.time_range)
    for name in ("engine.query", "engine.prepare", "engine.scan",
                 "engine.select", "engine.rung", "engine.wait"):
        assert name in ev, name
    (q,) = ev["engine.query"]
    for name in ("engine.prepare", "engine.scan", "engine.select"):
        (r,) = ev[name]
        assert q.start <= r.start and r.end <= q.end
    (sel,) = ev["engine.select"]
    assert all(sel.start <= r.start and r.end <= sel.end
               for r in ev["engine.rung"])
    # off: no program range reaches the profiler
    tracing.disable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.query(queries, top_k=10)
    assert not any(e.name.startswith(("engine.", "index."))
                   for e in prof.events())


def test_summarize_labels_gap_with_innermost_program_span():
    # a 10 ms slice (us): index.search over engine.select over a rung and
    # an aten op; the device idles from 4 to 9 ms under the rung
    events = [(SLICE, False, 0.0, 10000.0),
              ("index.search", False, 0.0, 10000.0),
              ("engine.query", False, 500.0, 9800.0),
              ("engine.select", False, 3000.0, 9500.0),
              ("engine.rung", False, 4000.0, 9000.0),
              ("aten::topk", False, 6000.0, 7000.0),
              ("kernel", True, 0.0, 4000.0),
              ("kernel", True, 9000.0, 10000.0)]
    tr = summarize(events)
    assert tr.gaps[0][0] == pytest.approx(0.005)
    assert tr.gaps[0][1] == "engine.rung / aten::topk"


def test_back_dated_span_is_in_the_registry_only():
    """A span started at an earlier ``start_ns`` (a server wave's wait)
    adds no profiler range: the range could not start in the past."""
    tracing.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("index.serve.wait",
                          start_ns=time.perf_counter_ns() - 2_000_000):
            pass
        with tracing.span("index.serve.dispatch"):
            pass
    names = {e.name for e in prof.events()}
    assert "index.serve.dispatch" in names
    assert "index.serve.wait" not in names
    count_, total, _ = tracing.snapshot()["spans"]["index.serve.wait"]
    assert count_ == 1 and total >= 2e-3


# -- counters ---------------------------------------------------------------

def test_launch_counts_as_before():
    build.reset_launch_counts()
    counts = build.launch_counts()
    assert set(counts) == set(build.LAUNCHES) and len(counts) == 24
    assert not any(counts.values())
    build.count("rerank")
    build.count("rerank")
    build.count("stream_mins_bf16")
    counts = build.launch_counts()
    assert counts["rerank"] == 2 and counts["stream_mins_bf16"] == 1
    assert sum(counts.values()) == 3
    with pytest.raises(KeyError):
        build.count("no_such_kernel")
    tracing.count("h2d_bytes", 4)      # other counters are not launches
    assert "h2d_bytes" not in build.launch_counts()
    build.reset_launch_counts()
    assert not any(build.launch_counts().values())
    assert tracing.snapshot()["counters"] == {}


@pytest.mark.parametrize("rungs", [(1,), (1, 2, 4)])
def test_rungs_and_terminal_scans_on_a_forced_ladder(data, rungs):
    """A first rung too small to certify (the forced ladder of
    ``test_torch_fused.py``): the counters say which rungs ran and that
    the terminal scan did."""
    cw, codes, queries = data
    eng = FusedCompressedEngine(cw, codes, precision="int16", device=CPU)
    table, qop, uq, (q2, err_r, scale2), b = eng.prepare(queries)
    mins, echo = eng.scan(qop, uq)
    tracing.reset()
    d, rows, ok, ok1 = pfused.fused_select_esc(
        mins, q2, table, echo, eng.n_valid, 10, rungs, 1, err_r=err_r,
        scale2=scale2, final_exact=True)
    # the ladder's rule, replayed on the plain epilogue
    mins_bn = fk.pool_mins_nb(mins, 1) * scale2
    ran = 0
    for ns in rungs:
        ran += 1
        _, _, ok_r = fk.select_rerank(mins_bn, q2, table, echo,
                                      eng.n_valid, 10, ns, 1,
                                      prepooled=True, err_r=err_r)
        if bool(ok_r.all()):
            break
    counts = tracing.snapshot()["counters"]
    assert not bool(ok1.all())
    assert counts["rungs"] == ran
    assert counts["terminal_scans"] == int(not bool(ok_r.all())) == 1


@pytest.mark.parametrize("precision", ["int16", "bf16"])
def test_per_query_ladder_counters_on_a_forced_ladder(data, monkeypatch,
                                                      precision):
    """The per-query route (taken here by CPU tensors, through the
    ladder's plain version) on a one-unit first rung: rows climb to 2, 8
    and the cap units alone; ``rungs`` is the deepest rung a real row
    reached, ``rung_rows`` the rungs the real rows ran, ``first_shot_rows``
    and ``real_rows`` leave the 28 padding rows out, and the answers equal
    the plain exact scan."""
    cw, codes, queries = data
    eng = FusedCompressedEngine(cw, codes, precision=precision, device=CPU)
    monkeypatch.setattr(pfused, "_per_query_route",
                        lambda mins, *a: fk.ladder_takes(*a))
    tracing.enable()
    d, ids = eng.query(queries, top_k=10, n_sub=1)
    snap = tracing.snapshot()
    counts = snap["counters"]
    # the same ladder replayed on the plain version
    table, qop, uq, (q2, err_r, scale2), b = eng.prepare(queries)
    mins, echo = eng.scan(qop, uq)
    mins_bn = fk.pool_mins_nb(mins, 1)
    if scale2 is not None:
        mins_bn = mins_bn * scale2
    rungs = (1, 2, 8, 127)                      # 128 units of 32 rows
    _, _, st = fk.fused_ladder_ref(mins_bn, q2, table, echo, eng.n_valid,
                                   10, rungs, 1, err_r=err_r)
    reached = torch.where(st == fk.LADDER_FAILED, 3, st.to(torch.int64))[:b]
    assert len(set(reached.tolist())) > 1      # rows climbed apart
    assert counts["rungs"] == int(reached.max()) + 1
    assert counts["rung_rows"] == int(reached.sum()) + b
    assert counts["real_rows"] == b == 100
    assert counts["first_shot_rows"] == int((st[:b] == 0).sum())
    assert counts.get("terminal_scans", 0) == int(
        bool((st == fk.LADDER_FAILED).any()))
    # the plain version ran: no kernel launched
    assert counts.get("ladder", 0) == counts.get("rerank", 0) == 0
    assert snap["spans"]["engine.ladder"][0] == 1
    assert "engine.rung" not in snap["spans"]
    assert eng.last_exact_frac == float((st == 0).to(torch.float32).mean())
    dr, _ = adc_query_topk(table[:b], echo, eng.n_valid, 10, 1024)
    assert np.array_equal(d, dr.numpy())
    cand = torch.from_numpy(np.ascontiguousarray(
        codes[ids].transpose(0, 2, 1)))         # each id's own code
    own = fk.rerank_table_sums_ref(table[:b].reshape(b, -1), cand)
    assert torch.equal(own, torch.from_numpy(d))


def test_first_shot_rows_leave_out_padding(data):
    cw, codes, queries = data
    eng = FusedCompressedEngine(cw, codes, precision="bf16", device=CPU)
    table, qop, uq, (q2, err_r, scale2), b = eng.prepare(queries)
    assert (b, table.shape[0]) == (100, 128)
    mins, echo = eng.scan(qop, uq)
    tracing.reset()
    _, _, ok1, first_frac = eng.ladder(table, (q2, err_r, scale2), mins,
                                       echo, b, 10)
    counts = tracing.snapshot()["counters"]
    assert counts["real_rows"] == 100
    # the 28 padding rows (all certified here) are left out; the rate
    # the ns_hint rule reads still counts them
    assert len(ok1) == 128 and int(ok1[100:].sum()) == 28
    assert counts["first_shot_rows"] == int(ok1[:100].sum())
    assert first_frac == float(ok1.to(torch.float32).mean())
    eng.select(table, (q2, err_r, scale2), mins, echo, b)
    assert eng.last_exact_frac == first_frac


def test_sharded_engine_counts_each_query_once(data):
    cw, codes, queries = data
    order = np.lexsort(codes.T[::-1])
    eng = ShardedCompressedEngine(cw, codes[order], make_mesh(2, device=CPU),
                                  row_to_db=order)
    tracing.reset()
    eng.query(queries, top_k=10)
    counts = tracing.snapshot()["counters"]
    assert counts["real_rows"] == 100
    assert counts["first_shot_rows"] == round(100 * eng.last_exact_frac)
    # the shards' own engines keep no rate of their own
    assert all(not hasattr(e, "last_exact_frac") for e, _ in eng.shards)


def test_sharded_per_query_ladder_counts_real_rows(data, monkeypatch):
    """The sharded engine on the per-query route (taken here by CPU
    tensors, through the ladder's plain version) with one-unit first
    rungs: ``rungs`` and ``rung_rows`` add up each shard's ladder over the
    100 real rows, the 28 padding rows left out; ``real_rows`` and
    ``first_shot_rows`` count each query once; the answers are exact."""
    cw, codes, queries = data
    order = np.lexsort(codes.T[::-1])
    eng = ShardedCompressedEngine(cw, codes[order], make_mesh(2, device=CPU),
                                  row_to_db=order)
    table, qop, uq, (q2, err_r, scale2), b = eng.shards[0][0].prepare(
        queries)
    assert (b, table.shape[0]) == (100, 128)
    # each shard's ladder replayed on the plain version
    want_rungs = want_rung_rows = 0
    first = torch.ones(b, dtype=torch.bool)
    for s, _ in eng.shards:
        s.ns_hint = 1
        mins, echo = s.scan(qop, uq)
        mins_bn = fk.pool_mins_nb(mins, 1)
        if scale2 is not None:
            mins_bn = mins_bn * scale2
        rungs = pfused.rung_plan(mins.shape[0], 10, 128, first=1).rungs
        assert rungs == (1, 2, 8, 63)               # 64 units of 32 rows
        _, _, st = fk.fused_ladder_ref(mins_bn, q2, table, echo, s.n_valid,
                                       10, rungs, 1, err_r=err_r)
        reached = torch.where(st == fk.LADDER_FAILED, 3, st.to(torch.int64))
        assert len(set(reached[:b].tolist())) > 1  # rows climbed apart
        assert int(reached[b:].sum()) > 0           # padding climbs too
        want_rungs += int(reached[:b].max()) + 1
        want_rung_rows += int(reached[:b].sum()) + b
        first &= st[:b] == 0
    monkeypatch.setattr(pfused, "_per_query_route",
                        lambda mins, *a: fk.ladder_takes(*a))
    tracing.enable()
    d, ids = eng.query(queries, top_k=10)
    counts = tracing.snapshot()["counters"]
    assert counts["rungs"] == want_rungs
    assert counts["rung_rows"] == want_rung_rows
    assert counts["real_rows"] == b
    assert counts["first_shot_rows"] == int(first.sum())
    assert eng.last_exact_frac == float(first.to(torch.float32).mean())
    dr, _ = adc_query_topk(table[:b], torch.from_numpy(codes), N, 10, 1024)
    assert np.array_equal(d, dr.numpy())
    cand = torch.from_numpy(np.ascontiguousarray(
        codes[ids].transpose(0, 2, 1)))         # each id's own code
    own = fk.rerank_table_sums_ref(table[:b].reshape(b, -1), cand)
    assert torch.equal(own, torch.from_numpy(d))


def test_engine_query_counts_real_rows(data):
    cw, codes, queries = data
    eng = FusedCodesEngine(cw, codes, device=CPU)
    eng.query(queries, top_k=10)
    eng.query(queries[:37], top_k=10)
    counts = tracing.snapshot()["counters"]
    assert counts["real_rows"] == 137
    assert counts["first_shot_rows"] <= 137
    assert counts["rungs"] >= 2


@pytest.mark.parametrize("precision", ["bf16", "int8", "int16"])
def test_h2d_bytes_equal_what_prepare_uploads(data, precision):
    cw, codes, queries = data
    eng = FusedCompressedEngine(cw, codes, precision=precision, device=CPU)
    tracing.reset()
    table, qop, uq, cert, b = eng.prepare(queries)
    b_pad, f32 = table.shape[0], 4
    want = b_pad * eng.D * f32 + qop.numel() * qop.element_size()
    if precision == "bf16":
        want += b_pad * eng.d_pad * f32                    # q2's queries
    else:
        want += uq.numel() * f32 + b_pad * f32             # u and e_q
    assert tracing.snapshot()["counters"]["h2d_bytes"] == want


def test_server_counts_dispatches_rows_and_waits(data):
    cw, codes, queries = data
    eng = FusedCodesEngine(cw, codes, device=CPU)
    tracing.enable()
    with CoalescingServer(eng, wave_rows=64, max_wait_ms=1.0) as srv:
        futs = [srv.submit(queries[i:i + 10]) for i in range(0, 100, 10)]
        for f in futs:
            assert f.result(timeout=60)[0].shape == (10, 10)
    snap = tracing.snapshot()
    counts, spans = snap["counters"], snap["spans"]
    assert counts["dispatches"] == srv.dispatches >= 2
    assert counts["rows_served"] == srv.rows_served == 100
    assert spans["index.serve.wait"][0] == 10          # one per wave
    assert spans["index.serve.dispatch"][0] == srv.dispatches
    assert spans["engine.query"][0] == srv.dispatches
    assert spans["index.serve.wait"][1] > 0


def test_index_spans_add_up(data):
    cw, codes, queries = data
    tracing.enable()
    t0 = time.perf_counter()
    idx = DeltaPQIndex(cw, codes, engine="fused_compressed", device=CPU)
    wall = time.perf_counter() - t0
    spans = tracing.snapshot()["spans"]
    split = [spans[f"index.build.{p}"]
             for p in ("edges", "layout", "serialize")]
    assert [s[0] for s in split] == [1, 1, 1]
    assert 0 < sum(s[1] for s in split) <= wall
    idx.search(queries, top_k=10)                # builds the engine
    tracing.reset()
    idx.search(queries, top_k=10)
    spans = tracing.snapshot()["spans"]
    assert "engine.build" not in spans
    for name in ("index.search", "index.finish", "engine.query",
                 "engine.prepare", "engine.scan", "engine.select",
                 "engine.rung", "engine.wait"):
        assert spans[name][0] >= 1, name
    # every span of the call lies under index.search: the self times sum
    # to its total
    total = spans["index.search"][1]
    assert sum(s[2] for s in spans.values()) == pytest.approx(total,
                                                             rel=1e-9)


def test_engine_build_span_at_first_search(data):
    cw, codes, queries = data
    idx = DeltaPQIndex(cw, codes, engine="fused_compressed", device=CPU)
    tracing.enable()
    idx.search(queries, top_k=10)
    spans = tracing.snapshot()["spans"]
    assert spans["engine.build"][0] == 1
    # the engine build is a child: outside index.search's self time
    search = spans["index.search"]
    assert search[2] <= search[1] - spans["engine.build"][1]


# -- the benchmark's readers ------------------------------------------------

@pytest.mark.parametrize("metric,counts,calls,want", [
    ("h2d_bytes_per_batch", {"h2d_bytes": 655360 * 4}, 4, 655360.0),
    ("terminal_per_batch", {"terminal_scans": 3}, 4, 0.75),
    ("terminal_per_batch", {}, 4, 0.0),
    ("first_shot_share", {"real_rows": 2048, "first_shot_rows": 1936}, 4,
     100.0 * 1936 / 2048),
    ("first_shot_share", {}, 4, None),
    ("h2d_bytes_per_batch", {"h2d_bytes": 1}, 0, None),
])
def test_counter_readers(metric, counts, calls, want):
    for name, n in counts.items():
        tracing.count(name, n)
    got = bench_run.reader(metric)(SimpleNamespace(calls=calls))
    assert got == (pytest.approx(want) if want is not None else None)


def test_readers_see_the_window_and_not_the_warm_up(monkeypatch):
    """``run_cell`` resets the registry after warm-up (through
    ``build.reset_launch_counts()``), so its counter readers read the
    window's batches alone."""
    import copy

    spec = copy.deepcopy(bench_run.load_spec("sift1m.batch"))
    spec["config"].update(n_base=4096, n_learn=2048, n_queries=300, D=32,
                          M=8, K=16, kmeans_iters=5,
                          engine="fused_compressed")
    spec["traffic"]["batch"] = 64
    gen = __import__("benchmark.generators.closed_batch",
                     fromlist=["run"])
    seen = {}
    real_run = gen.run

    def run(s):
        seen["at_start"] = tracing.snapshot()["counters"]
        real_run(s)
        seen["calls"] = s.calls
        seen["window"] = tracing.snapshot()["counters"]

    monkeypatch.setattr(gen, "run", run)
    out = bench_run.run_cell("sift1m.batch", 3, 0.3, True, "cpu", spec)
    assert out["correct"], out["checks"]
    assert seen["at_start"] == {}
    window, calls = seen["window"], seen["calls"]
    assert window["real_rows"] == 64 * calls        # no warm-up batch
    got = out["metrics"]
    assert got["h2d_bytes_per_batch"]["value"] == pytest.approx(
        window["h2d_bytes"] / calls)
    assert got["first_shot_share"]["value"] == pytest.approx(
        100.0 * window["first_shot_rows"] / window["real_rows"])
    assert got["terminal_per_batch"]["value"] == pytest.approx(
        window.get("terminal_scans", 0) / calls)


def test_counter_readers_without_the_registry(monkeypatch):
    """On a tree of the port without ``tracing`` the readers give None."""
    import builtins

    real_import = builtins.__import__

    def no_tracing(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "deltapq_tpu_torch" and "tracing" in (fromlist or ()):
            raise ImportError("no tracing")
        return real_import(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracing)
    tracing.count("h2d_bytes", 10)
    for metric in ("h2d_bytes_per_batch", "first_shot_share",
                   "terminal_per_batch"):
        assert bench_run.reader(metric)(SimpleNamespace(calls=1)) is None
