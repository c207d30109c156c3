"""Spans and counters inside the port: where a query batch's time goes.

Spans are off by default.  ``span(name, **attrs)`` is a context manager:

- off, it returns a shared no-op after one flag check (no allocation, no
  clock, no profiler range);
- on (``enable()``), it reads ``time.perf_counter_ns()`` at entry and
  exit and adds, per name, the count, the total time and the self time
  (the duration less what its child spans cover) to an in-memory table.
  Parents come from a stack kept per thread.  A span opened with no
  parent (``index.search``, a server dispatch) takes a call id, which
  its child spans carry;
- while a ``torch.profiler`` is recording, an enabled span also opens
  ``torch.profiler.record_function(name)``, with its call id and
  attributes as the range's args, so its range lies on the profiler's
  timeline beside the kernels (and in ``profiling.trace``'s Chrome
  trace).

``count(name, n)`` is always on: an integer add under a lock, no clock
and no device read.  The kernel launch counts of ``kernels.build`` are
counters of this registry.

``snapshot()`` returns ``{"spans": {name: (count, total_s, self_s)},
"counters": {name: int}}``; ``reset()`` zeroes both.  Readers of a
measured window depend on a reset just before it opens: the benchmark
calls ``kernels.build.reset_launch_counts()``, which is ``reset()``, after
its warm-up, and reads the registry after the window.

Every span name starts with ``index.`` or ``engine.``: a profiler
mirrors host ranges onto the device's timeline, and readers of the
device's busy time drop ranges of those prefixes there.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List

import torch

__all__ = ["span", "count", "enable", "disable", "reset", "snapshot"]

_on = False
_lock = threading.Lock()
#: name -> [count, total_ns, self_ns]
_spans: Dict[str, List[int]] = {}
_counters: Dict[str, int] = {}
_local = threading.local()
_call_ids = itertools.count(1)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "t0", "child", "call", "rf")

    def __init__(self, name: str, attrs: dict, start_ns):
        self.name, self.attrs, self.t0 = name, attrs, start_ns
        self.child = 0
        self.rf = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.call = stack[-1].call if stack else next(_call_ids)
        stack.append(self)
        if self.t0 is None and torch.autograd._profiler_enabled():
            args = ",".join([f"call={self.call}"] + [
                f"{k}={v}" for k, v in self.attrs.items()])
            self.rf = torch.profiler.record_function(self.name, args)
            self.rf.__enter__()
        if self.t0 is None:
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child += dur
        with _lock:
            rec = _spans.get(self.name)
            if rec is None:
                rec = _spans[self.name] = [0, 0, 0]
            rec[0] += 1
            rec[1] += dur
            rec[2] += dur - self.child
        return False


def span(name: str, start_ns=None, **attrs):
    """A span around the ``with`` block, recorded when tracing is on.
    ``start_ns`` (a ``time.perf_counter_ns()`` reading) starts it at an
    earlier moment, for a wait that began elsewhere (a server wave's
    submit); such a span has no parent of its own and lives in the
    registry only: a profiler range cannot open in the past, so it adds
    none."""
    if not _on:
        return _OFF
    return _Span(name, attrs, start_ns)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (always on)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Zero every span and counter."""
    with _lock:
        _spans.clear()
        _counters.clear()


def snapshot() -> dict:
    with _lock:
        return {"spans": {k: (c, t * 1e-9, s * 1e-9)
                          for k, (c, t, s) in _spans.items()},
                "counters": dict(_counters)}
