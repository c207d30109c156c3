"""A ``torch.profiler`` slice of the window and what is read from it.

``Tracer`` profiles a steady slice of the measured window: it starts
``start_s`` into the window and stops ``length_s`` later, both checked
between calls, so the slice holds whole calls.  ``summarize`` reduces
the profile to what the per-layer metrics read: the slice's length, the
union of device activity inside it, device time and count per kernel
name, and the longest idle gaps with the host ranges that covered them.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

SLICE = "bench.slice"
#: prefixes of the host ranges the harness puts around calls into the
#: program
SPANS = ("bench.", "index.", "engine.")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    #: device seconds and launches by kernel (or copy) name
    device_ops: Dict[str, List[float]] = field(default_factory=dict)
    #: (seconds, host range) of the longest idle gaps, longest first
    gaps: List[Tuple[float, str]] = field(default_factory=list)
    calls: int = 0        # harness calls completed inside the slice


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without ``void`` and its argument list."""
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:width]


def _events(prof):
    """(name, on_device, start_us, end_us) of every profiled event, from
    the profiler's raw events (cheap to read), or where this torch lacks
    them from its event list."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof.profiler, "kineto_results", None),
                  "events", None)
    if raw is not None and hasattr(torch._C._autograd._KinetoEvent,
                                   "start_ns"):
        out = []
        for e in raw():
            s = e.start_ns() * 1e-3
            out.append((e.name(), e.device_type() == cuda, s,
                        s + e.duration_ns() * 1e-3))
    else:
        out = [(e.name, e.device_type == cuda, float(e.time_range.start),
                float(e.time_range.end)) for e in prof.events()]
    # the profiler mirrors the harness's host ranges on the device's
    # timeline, where they are no work
    return [e for e in out if not (e[1] and e[0].startswith(SPANS))]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events, n_gaps: int = 10) -> Optional[Trace]:
    """Reduce ``(name, on_device, start_us, end_us)`` events to a
    ``Trace``; None when the slice's own range is missing."""
    events = list(events)
    window = [(s, e) for n, dev, s, e in events if not dev and n == SLICE]
    if not window:
        return None
    w0, w1 = window[0]
    dev = [(n, max(s, w0), min(e, w1)) for n, d, s, e in events
           if d and e > w0 and s < w1]
    ops: Dict[str, List[float]] = {}
    for n, s, e in dev:
        o = ops.setdefault(short_name(n), [0.0, 0])
        o[0] += (e - s) * 1e-6
        o[1] += 1
    busy = _union([(s, e) for _, s, e in dev if e > s])
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [(n, s, e) for n, d, s, e in events if not d and n != SLICE]
    labelled = []
    for g0, g1 in gaps[:n_gaps]:
        mid = 0.5 * (g0 + g1)
        cover = sorted((e - s, n) for n, s, e in host if s <= mid <= e)
        spans = [n for _, n in cover if not n.startswith("aten::")]
        label = " / ".join(x for x in (spans[0] if spans else "",
                                       cover[0][1] if cover else "")
                           if x) or "no host range"
        labelled.append(((g1 - g0) * 1e-6, label))
    return Trace(window_s=(w1 - w0) * 1e-6,
                 busy_s=sum(e - s for s, e in busy) * 1e-6,
                 device_ops=ops, gaps=labelled)


class Tracer:
    """Profiles ``length_s`` of the window from ``start_s`` on, when
    enabled; ``tick`` is called between calls with the seconds since the
    window opened.  ``prime`` opens and closes one empty profile in
    set-up, so that the profiler's own start-up is not paid in the
    window."""

    def __init__(self, enabled: bool, start_s: float, length_s: float,
                 device: torch.device):
        self.enabled = enabled
        self.start_s, self.length_s = start_s, length_s
        self.device = device
        self._started = 0.0
        self.read_s = 0.0
        self.trace: Optional[Trace] = None
        self._prof = None
        self._span = None
        self._calls = 0
        self._done = False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def prime(self) -> None:
        if self.enabled:
            with self._profile():
                self._sync()

    def tick(self, elapsed: float) -> None:
        if not self.enabled or self._done:
            return
        if self._prof is None and elapsed >= self.start_s:
            self._prof = self._profile()
            self._prof.__enter__()
            self._span = torch.profiler.record_function(SLICE)
            self._span.__enter__()
            self._calls = 0
            self._started = elapsed
        elif (self._prof is not None
              and elapsed >= self._started + self.length_s):
            self.finish()

    def call_done(self) -> None:
        if self._prof is not None:
            self._calls += 1

    def finish(self) -> None:
        """Close the slice (at the window's end at the latest)."""
        if self._prof is None or self._done:
            return
        self._sync()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._done = True
        t = time.perf_counter()
        self.trace = summarize(_events(self._prof))
        self.read_s = time.perf_counter() - t
        if self.trace is not None:
            self.trace.calls = self._calls
        self._prof = None


@contextlib.contextmanager
def span(name: str, enabled: bool):
    """A host range in the profile around a call into the program."""
    if not enabled:
        yield
        return
    with torch.profiler.record_function(name):
        yield


def wrap_method(obj, name: str, label: str) -> None:
    """Put a host range around ``obj.name`` (an instance attribute
    shadowing the method); used only in traced runs."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)

    setattr(obj, name, wrapped)
