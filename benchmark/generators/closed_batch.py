"""Closed loop: back-to-back batches of ``batch`` queries.

Batch i takes the queries i*batch, i*batch + 1, ... of the query set,
wrapping around, so every batch has the same size.  The window ends with
the first batch whose answers reach host memory after ``seconds``.  Each
batch's wall, call to answers in host memory, is kept in ``latencies``;
the window's notes give their p95 and the rate in each quarter of the
window.
"""

from __future__ import annotations

import numpy as np

#: warm-up batches: enough for the engine's certificate calibration (its
#: first rung doubles once a batch while the first-shot rate is low)
WARM_BATCHES = 8


def _rows(i: int, b: int, nq: int) -> np.ndarray:
    return (np.arange(b) + i * b) % nq


def warmup(s) -> None:
    b = s.traffic["batch"]
    for i in range(WARM_BATCHES):
        s.search(s.queries[_rows(i, b, len(s.queries))])


def run(s) -> None:
    b = s.traffic["batch"]
    nq = len(s.queries)
    t0 = s.clock()
    s.window_start = t0
    i = 0
    ends = []
    while True:
        s.tracer.tick(s.clock() - t0)
        rows = _rows(i, b, nq)
        t_call = s.clock()
        d, ids = s.search(s.queries[rows])
        t1 = s.clock()
        s.latencies.append(t1 - t_call)
        ends.append(t1 - t0)
        s.tracer.call_done()
        s.attempted += b
        s.offer_sample(rows, (d, ids))
        i += 1
        if t1 - t0 >= s.seconds:
            break
    s.tracer.finish()
    s.window_s = t1 - t0
    s.calls = i
    per = np.histogram(ends, np.linspace(0.0, s.window_s, 5))[0]
    s.notes.update(
        batch_p95_ms=float(np.percentile(s.latencies, 95) * 1e3),
        qps_by_quarter=[float(x) for x in per * b / (s.window_s / 4)])
