"""Wave-coalescing serving layer.

Counterpart of ``deltapq_tpu/serving.py``: NumPy and threads over any
engine with ``query(queries, top_k) -> (dists, ids)``.  No reference
counterpart: the reference scans one query at a time
(``pq_tree.cpp:434-503``).

An engine's batch carries work that does not grow with the batch (the
stream tier's decode of every tile, the table and launch set-up), so
wider dispatches amortize it.  ``CoalescingServer`` turns that into
served throughput: clients ``submit()`` query waves of any size; the
server concatenates queued waves until ``wave_rows`` rows are pending
(or ``max_wait_ms`` passes), runs ONE engine dispatch, and fans results
back out per wave, never splitting a wave.  Cost: at most one extra wave
of queueing latency.  Its dispatches run one at a time.  Each wave takes
an id at ``submit``; with ``tracing`` on, its wait from ``submit`` to its
dispatch is the span ``index.serve.wait`` (in ``tracing``'s registry
only: no profiler range) and each dispatch the span
``index.serve.dispatch`` (with the ids of its waves); ``dispatches`` and
``rows_served`` are counters of ``tracing``'s registry besides.

``query_coalesced`` is the synchronous offline variant (a list of
batches, grouped into big dispatches).
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from typing import List, Sequence, Tuple

import numpy as np

from . import tracing

__all__ = ["query_coalesced", "CoalescingServer"]


def query_coalesced(engine, batches: Sequence[np.ndarray],
                    top_k: int = 10, wave_rows: int = 1024
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Run ``engine.query`` over ``batches`` with adjacent batches
    concatenated into dispatches of up to ``wave_rows`` rows.  Returns
    one ``(distances, ids)`` pair per input batch, identical to
    querying each batch alone (the kernel computes per-query rows
    independently)."""
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    group: List[np.ndarray] = []
    rows = 0

    def flush():
        nonlocal rows
        if not group:
            return
        d, ids = engine.query(np.concatenate(group, axis=0),
                              top_k=top_k)
        o = 0
        for g in group:
            out.append((d[o:o + len(g)], ids[o:o + len(g)]))
            o += len(g)
        group.clear()
        rows = 0

    for b in batches:
        b = np.asarray(b)
        if rows and rows + len(b) > wave_rows:
            flush()
        group.append(b)
        rows += len(b)
        if rows >= wave_rows:
            flush()
    flush()
    return out


class CoalescingServer:
    """Background-thread query server that coalesces submitted waves.

    Parameters
    ----------
    engine : any object with ``query(queries, top_k) -> (d, ids)``
        (the fused engines, ``DeltaPQIndex.search`` via a shim, ...).
    wave_rows : dispatch as soon as this many rows are queued.
    max_wait_ms : dispatch a partial wave after this long — bounds the
        added latency when traffic is light.
    top_k : fixed per server.
    """

    def __init__(self, engine, wave_rows: int = 1024,
                 max_wait_ms: float = 2.0, top_k: int = 10,
                 warmup: bool = False):
        self.engine = engine
        self.wave_rows = int(wave_rows)
        self.max_wait = max_wait_ms / 1e3
        self.top_k = top_k
        if warmup and hasattr(engine, "warmup"):
            # run the full wave shape once before accepting traffic, so
            # the first wave finds the engine calibrated
            engine.warmup(batch_sizes=(self.wave_rows,), top_k=top_k)
        self._lock = threading.Condition()
        #: (queries, future, wave id, submit time in perf_counter_ns)
        self._queue: List[Tuple[np.ndarray, Future, int, int]] = []
        self._wave_ids = itertools.count(1)
        self._rows = 0
        self._closed = False
        self.dispatches = 0
        self.rows_served = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, queries: np.ndarray) -> Future:
        """Queue a wave; resolves to ``(distances, ids)`` for it."""
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        fut: Future = Future()
        with self._lock:
            if self._closed:
                # closed-server submits raise for EVERY wave shape —
                # including 0-row waves (the empty-wave shortcut below
                # must not mask a closed server)
                raise RuntimeError("server closed")
            if len(queries) == 0:
                # resolve empty waves immediately: queueing one would
                # waste a dispatch, and engines differ on 0-row batches
                fut.set_result((np.zeros((0, self.top_k), np.float32),
                                np.zeros((0, self.top_k), np.int64)))
                return fut
            self._queue.append((queries, fut, next(self._wave_ids),
                                time.perf_counter_ns()))
            self._rows += len(queries)
            self._lock.notify()
        return fut

    def query(self, queries: np.ndarray, top_k: int = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking convenience wrapper around ``submit``."""
        if top_k is not None and top_k != self.top_k:
            raise ValueError("top_k is fixed per server")
        return self.submit(queries).result()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internal ------------------------------------------------------
    def _take_wave(self) -> List[Tuple[np.ndarray, Future, int, int]]:
        """Wait until a full wave, the max-wait deadline of the oldest
        entry, or close; pop at most ``wave_rows`` rows (never
        splitting a submitted wave across dispatches)."""
        with self._lock:
            deadline = None
            while True:
                if self._queue and deadline is None:
                    deadline = time.monotonic() + self.max_wait
                if self._rows >= self.wave_rows:
                    break
                if self._closed:
                    break
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._lock.wait(timeout=left)
                else:
                    self._lock.wait()
                if not self._queue and self._closed:
                    break
            taken, rows = [], 0
            while self._queue and (not taken
                                   or rows + len(self._queue[0][0])
                                   <= self.wave_rows):
                entry = self._queue.pop(0)
                taken.append(entry)
                rows += len(entry[0])
            self._rows -= rows
            return taken

    def _loop(self) -> None:
        while True:
            wave = self._take_wave()
            if not wave:
                with self._lock:
                    if self._closed and not self._queue:
                        return
                continue
            # claim each future before doing work: a client may have
            # cancelled a PENDING future, and set_result on it raises
            # InvalidStateError — which would kill this thread and hang
            # every later submit().  Cancelled entries are skipped (the
            # rows still run if they share a dispatch; harmless).
            live = [w for w in wave if w[1].set_running_or_notify_cancel()]
            if not live:
                continue
            for _, _, wave_id, t_submit in live:
                with tracing.span("index.serve.wait", start_ns=t_submit,
                                  wave=wave_id):
                    pass
            qs = np.concatenate([w[0] for w in live], axis=0)
            try:
                with tracing.span("index.serve.dispatch",
                                  waves=":".join(str(w[2]) for w in live)):
                    d, ids = self.engine.query(qs, top_k=self.top_k)
            except Exception as e:  # pragma: no cover - engine fault
                for _, f, _, _ in live:
                    try:
                        f.set_exception(e)
                    except Exception:
                        pass
                continue
            self.dispatches += 1
            self.rows_served += len(qs)
            tracing.count("dispatches")
            tracing.count("rows_served", len(qs))
            o = 0
            for q, f, _, _ in live:
                try:
                    f.set_result((d[o:o + len(q)], ids[o:o + len(q)]))
                except Exception:  # pragma: no cover - racing cancel
                    pass
                o += len(q)
