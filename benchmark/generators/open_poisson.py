"""Open loop: requests on a Poisson schedule through ``CoalescingServer``.

A request carries ``sizes`` queries (each size equally often); requests
arrive at ``rate_qps / mean size`` a second.  Every seed gets the same
set of sizes and the same set of gaps between arrivals, the gaps being
the exponential distribution's quantiles, in an order of its own, so
seeds change which queries and in what order, not how much work.

A request is timed from its scheduled send time to its answer; the
generator's own lateness (actual send less scheduled) is reported
apart.  Answers are awaited up to ``drain_s`` (a minute unless the
sweep asks for less) past the window's close;
one that never comes counts as failed, and ``stop`` cancels what is still
queued so that the server closes at once.
"""

from __future__ import annotations

import threading
import time

import numpy as np

DRAIN_S = 60.0


def schedule(traffic: dict, seconds: float, seed: int):
    """(send times [n] s from the window's start, sizes [n])."""
    sizes_set = np.asarray(traffic["sizes"], np.int64)
    rate_req = traffic["rate_qps"] / sizes_set.mean()
    n = max(1, int(round(rate_req * seconds)))
    rng = np.random.default_rng([int(seed) % 2 ** 64, 11])
    sizes = rng.permutation(np.resize(sizes_set, n))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate_req
    gaps = rng.permutation(gaps)
    return np.cumsum(gaps) - gaps[0], sizes


class _Shim:
    """``DeltaPQIndex.search`` under the engine interface the server
    takes; keeps the host wall of each dispatch."""

    def __init__(self, search):
        self._search = search
        self.walls = []

    def query(self, queries, top_k):
        t = time.perf_counter()
        out = self._search(queries, top_k)
        self.walls.append(time.perf_counter() - t)
        return out


def _server(s):
    from deltapq_tpu_torch.serving import CoalescingServer

    t = s.traffic
    return CoalescingServer(_Shim(s.search_k), wave_rows=t["wave_rows"],
                            max_wait_ms=t["max_wait_ms"], top_k=s.top_k)


def stop(s) -> None:
    """Cancel the requests still queued, then close the server."""
    for f in s.futures:
        f.cancel()
    s.server.close()


def warmup(s) -> None:
    """Every dispatch width the server can form (the engines pad a batch
    to a multiple of 128 rows), then a few requests through the server."""
    w = s.traffic["wave_rows"]
    for b in list(range(128, w + 1, 128)) * 2:
        s.search(s.queries[np.arange(b) % len(s.queries)])
    s.server = _server(s)
    futs = [s.server.submit(s.queries[:int(k)])
            for k in s.traffic["sizes"]]
    for f in futs:
        f.result(timeout=DRAIN_S)


def run(s, drain_s: float = DRAIN_S) -> None:
    times, sizes = schedule(s.traffic, s.seconds, s.seed)
    nq = len(s.queries)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]) % nq
    n = len(times)
    done_at = np.full(n, np.nan)
    late = np.zeros(n)
    lock = threading.Lock()
    left = [n]
    all_done = threading.Event()
    server = s.server
    s.futures = []
    d0, r0 = server.dispatches, server.rows_served
    server.engine.walls.clear()

    def on_done(f, r):
        if f.exception() is None:
            done_at[r] = time.perf_counter()
        with lock:
            left[0] -= 1
            if left[0] == 0:
                all_done.set()

    t0 = s.clock()
    s.window_start = t0
    for r in range(n):
        due = t0 + times[r]
        wait = due - s.clock()
        if wait > 0:
            time.sleep(wait)
        s.tracer.tick(s.clock() - t0)
        rows = (starts[r] + np.arange(sizes[r])) % nq
        now = s.clock()
        late[r] = now - due
        f = server.submit(s.queries[rows])
        f.add_done_callback(lambda f, r=r: on_done(f, r))
        s.futures.append(f)
        s.offer_sample(rows, f)
    t_sent = s.clock()
    s.tracer.finish()
    all_done.wait(timeout=max(0.0, t0 + s.seconds + drain_s - t_sent))
    s.window_s = max(t_sent, t0 + s.seconds) - t0
    answered = ~np.isnan(done_at)
    s.latencies = list(done_at[answered] - (t0 + times[answered]))
    s.attempted = n
    s.failed = int(n - answered.sum())
    s.calls = n
    s.counters["dispatches"] = server.dispatches - d0
    s.counters["rows_served"] = server.rows_served - r0
    s.notes["lateness_p50_ms"] = float(np.median(late) * 1e3)
    s.notes["lateness_p99_ms"] = float(np.quantile(late, 0.99) * 1e3)
    s.notes["lateness_max_ms"] = float(late.max() * 1e3)
    walls = np.asarray(server.engine.walls) * 1e3
    if len(walls):
        s.notes["dispatch_ms_p50"] = float(np.median(walls))
        s.notes["dispatch_ms_max"] = float(walls.max())
    if answered.any():
        s.notes["answered_qps"] = float(
            sizes[answered].sum() / (np.nanmax(done_at) - t0))
    s.notes["requests"] = n
    s.notes["queries"] = int(sizes.sum())
