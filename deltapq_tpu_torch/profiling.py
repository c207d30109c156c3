"""Timers, device-memory observability, structured metrics.

Counterpart of ``deltapq_tpu/profiling.py``.  ``Metrics`` and
``host_mem_usage`` are copies (the tests hold ``Metrics.dump`` equal to
the original's); ``device_mem_stats`` reads ``torch.cuda.memory_stats``
and ``trace`` records a ``torch.profiler`` trace where the JAX package
uses ``jax.profiler``.

Reference equivalents: ``Elapsed()`` wall-clock prints
(``utils.cpp:112-116``) and ``/proc/self/stat`` VM/RSS parsing
(``process_mem_usage``, ``utils.cpp:165-184``) sprinkled at every stage.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


class Metrics:
    """Per-run structured metrics: stage timings + counters."""

    def __init__(self):
        self.data: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time the enclosed block as ``time_{name}_s`` (accumulating).
        ``sync`` runs before the clock stops: pass
        ``torch.cuda.synchronize`` where the block launches device work
        that it does not wait for."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync()
        self.data[f"time_{name}_s"] = round(
            self.data.get(f"time_{name}_s", 0.0)
            + time.perf_counter() - t0, 6)

    def set(self, name: str, value):
        self.data[name] = value

    def dump(self, path: Optional[str] = None) -> str:
        blob = json.dumps(self.data, indent=2, sort_keys=True, default=str)
        if path:
            with open(path, "w") as f:
                f.write(blob)
        return blob


def host_mem_usage() -> Dict[str, float]:
    """VM/RSS in KB (reference ``process_mem_usage``,
    ``utils.cpp:165-184``)."""
    try:
        with open("/proc/self/statm") as f:
            vm_pages, rss_pages = (int(x) for x in f.read().split()[:2])
        page_kb = os.sysconf("SC_PAGE_SIZE") / 1024
        return {"vm_kb": vm_pages * page_kb, "rss_kb": rss_pages * page_kb}
    except OSError:
        return {"vm_kb": 0.0, "rss_kb": 0.0}


def device_mem_stats() -> Dict[str, Dict]:
    """Per-card memory stats of this process's caching allocator, under
    the JAX package's key names; empty without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the enclosed block (host and, where
    there is a card, device activity), written to ``log_dir`` as a
    Chrome trace viewable in Perfetto."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
